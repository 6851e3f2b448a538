"""Model parts, one file each, found by the names a configuration lists in
``models`` (``core.spec.model_part``).

A configuration's block under the part's name holds its widths and
source.  A part file ``<part>.py`` gives:

* ``ROLE``: its place in the method, ``"rgb"`` or ``"xyz"`` (a backbone
  that reads the test parts) or ``"fusion"`` (a net that reads the
  backbones' features); the banks of the same names hold its rows;
* ``CHECKPOINT_PREFIX``: the prefix the reference strips from the
  checkpoint's names (``""`` for none);
* ``NOT_WIDTHS``: the keys of its block that are not widths (sources,
  weight scales, the traffic's capacities); the shape check compares every
  other key with what the program runs;
* ``leaves(c)``: the checkpoint-named leaves ``(name, shape, kind, scale)``
  of block ``c`` (``core/weights.py``);
* ``features(sd, inputs, c)``: the plain reference's forward
  (``perfbench/reference/``) from the state dict ``sd``, prefix stripped,
  to the part's features.  ``inputs`` holds, for a backbone, the block's
  stacked test parts (``rgb`` (B, H, W, 3), ``organized_pc`` (B, H, W, 3),
  ``points_compact`` (B, capacity, 3)), for a fusion net the features by
  role (``xyz``, ``rgb``);
* ``load(backbone, fusion, sd)``: the checkpoint-named numpy state dict
  loaded into the port's built ``DualBackbone`` or fusion net;
* ``widths(backbone, fusion)``: the widths the program runs, under the
  block's keys.

Parts of one configuration are used in the order of its ``models``; a
model's weight stream is its index there.
"""
