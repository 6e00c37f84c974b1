"""Percent of the routed (token, held expert) pairs that the experts'
capacity dropped over the window's steps: the program's device counters
``moe.dropped`` over ``moe.routed`` (``repro_torch.obs.default_counters``,
read once after the window).  None where the program keeps no such
counters or routed nothing."""


def read(run):
    try:
        from repro_torch.obs import default_counters
    except ImportError:
        return None
    counts = default_counters().read()
    if not counts.get("moe.routed"):
        return None
    return 100.0 * counts.get("moe.dropped", 0) / counts["moe.routed"]
