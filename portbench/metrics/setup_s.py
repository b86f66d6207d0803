"""setup_s: seconds from the process's start to the window's first timed
call (imports, the program's build and kernel library, weights and inputs
made on the card, the warm-up)."""


def read(rec):
    return rec["setup_s"]
