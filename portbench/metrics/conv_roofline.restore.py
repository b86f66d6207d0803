"""conv_roofline.restore: the traced calls' dense convolution FLOPs (the
reference's count) over the device time of the operations in the conv
families (``families/*.json`` with ``conv``) and the card's dense
peak for the configuration's dtype, in percent."""


def read(rec):
    tr = rec.get("trace")
    if (rec["kind"] != "restore" or tr is None or not tr["conv_s"]
            or rec["peak_flops"] is None):
        return None
    work = rec["conv_per_call"] * tr["calls"]
    return 100.0 * work / (tr["conv_s"] * rec["peak_flops"])
