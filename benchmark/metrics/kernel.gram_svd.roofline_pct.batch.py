"""gram_svd's share of its roofline: the frozen count's least time for one
fit's launch (the voxels of one llc_kbdm_fit call x sweep entries matrices
of k x k, the configured eigh_sweeps) over the mean device time of a
launch in the trace."""
from benchmark import readers


def read(rec):
    s = readers.fit_shape(rec)
    if s is None:
        return None
    bound = readers.bounds.gram_svd(s["batch"], s["k"], s["eigh_sweeps"])
    return readers.roofline_pct(rec, "gram_svd_kernel", bound)
