"""eig_cs's share of its roofline: the frozen count's least time for one
fit's launch (the voxels of one llc_kbdm_fit call x sweep entries matrices
of p x p, the configured eig_sweeps) over the mean device time of a launch
in the trace."""
from benchmark import readers


def read(rec):
    s = readers.fit_shape(rec)
    if s is None:
        return None
    bound = readers.bounds.eig_cs(s["batch"], s["p"], s["eig_sweeps"])
    return readers.roofline_pct(rec, "eig_cs_kernel", bound)
