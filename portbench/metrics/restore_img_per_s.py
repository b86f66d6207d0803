"""restore_img_per_s: the images every call of the window returned,
synchronised, over the window (its first call to its last synchronise)."""


def read(rec):
    if rec["kind"] != "restore":
        return None
    return rec["items"] / rec["window_s"]
