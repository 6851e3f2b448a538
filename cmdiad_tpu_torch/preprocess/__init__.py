"""Offline dataset preprocessing on the card: MVTec 3D-AD in place
(``mvtec``: RANSAC plane removal, square padding, largest-DBSCAN-cluster
cleaning) and the Eyecandies conversion (``eyecandies``)."""
