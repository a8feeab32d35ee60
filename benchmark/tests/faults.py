"""Entries that break the program's timed path underneath a run, for
test_bm_faults.py: each calls the real captured entry and spoils what it
returns, as a fault in the program would."""

from stereo_matchin_tpu_torch.models import asw, cross_based

ENTRIES = {"asw": asw.asw_pipeline, "cross": cross_based.cross_pipeline}
FIELDS = {"asw": ("disparity", "consistency_pre", "consistency_post"),
          "cross": ("initial", "final", "median_left")}


def _spoil(res, method, how):
    out = {}
    for f in FIELDS[method]:
        t = getattr(res, f).clone()
        if how == "altered":
            # One answer altered where it is produced: pixel (0, 0).
            t[0, 0] = 1.0 - t[0, 0]
        elif how == "half":
            # The bottom half of the frame's rows left out.
            t[t.shape[0] // 2:] = -1.0
        out[f] = t
    return res._replace(**out)


class _Stale:
    """Returns the previous call's result: a replay whose outputs are not
    refreshed."""

    def __init__(self, method):
        self.method, self.last = method, None

    def __call__(self, left, right, cfg):
        res = ENTRIES[self.method](left, right, cfg)
        prev, self.last = self.last, res
        return res if prev is None else prev


def _make(method, how):
    if how == "stale":
        return _Stale(method)
    return lambda left, right, cfg: _spoil(ENTRIES[method](left, right, cfg),
                                           method, how)


asw_altered = _make("asw", "altered")
asw_half = _make("asw", "half")
asw_stale = _make("asw", "stale")
cross_altered = _make("cross", "altered")
cross_half = _make("cross", "half")
cross_stale = _make("cross", "stale")
