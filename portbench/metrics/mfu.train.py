"""mfu.train: the window's dense FLOPs, counted on the reference model at
the cell's shapes (``lib/flops.py``), over the window's time and the
card's dense peak for the configuration's dtype, in percent."""


def read(rec):
    if rec["kind"] != "train" or rec["peak_flops"] is None:
        return None
    work = rec["work_per_call"] * rec["n_calls"]
    return 100.0 * work / (rec["window_s"] * rec["peak_flops"])
