"""discarded_step_pct.restore: the share of the traced calls' sampling
steps that ran after the step whose x0 the output keeps, in percent:
100 x ``chain.steps_after_kept`` / ``chain.steps_run`` of the program's
chain counters (``profiling.CHAIN``) over the traced calls.  Their UNet
calls feed nothing.  None where the run kept no counters (a program
without them) or ran no step."""


def read(rec):
    tr = rec.get("trace")
    counts = None if tr is None else tr.get("chain_counts")
    if rec.get("kind") != "restore" or not counts or not counts.get(
            "chain.steps_run"):
        return None
    return 100.0 * counts["chain.steps_after_kept"] / counts["chain.steps_run"]
