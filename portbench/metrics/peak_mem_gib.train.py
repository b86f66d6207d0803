"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated`` over the
window, reset at its start, in GiB."""


def read(rec):
    if rec["kind"] != "train" or not rec["peak_mem_bytes"]:
        return None
    return rec["peak_mem_bytes"] / 2.0 ** 30
