"""idle_pct.restore: the share of the traced window in which no kernel,
copy or memset ran on the card (the union of their intervals), in
percent."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "restore" or tr is None or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
