"""Share of the bank-min work's roofline: the least time of the cross term
of every call inside the ``bank_min`` span (``counts/bank_min.py``, from
the call's query and bank shapes, whatever implements it) over the device
time of everything those calls launched, the quantisation and the exact
refine included."""

from perfbench.counts import bank_min


def read(ctx):
    device_s = ctx.reduced.span_device_s.get("bank_min")
    calls = ctx.calls.get("bank_min")
    if not device_s or not calls:
        return None
    least = sum(bank_min.least_s(q[0], b[0], q[1]) for q, b, *_ in calls)
    return 100.0 * least / device_s
