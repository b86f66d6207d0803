"""train_crops_per_s: the crops of every whole step of the window over
the window (its first step to the loss read that closes it)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["items"] / rec["window_s"]
