"""Operations and bytes of one model part, from a configuration's shapes.

Each module gives ``least_s(...)``: the least time the part can take on the
card, max(operations / peak, bytes / bandwidth), from ``core.peaks``.
"""
