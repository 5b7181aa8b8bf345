"""setup_s (host clock): from the process's start to the window's opening:
imports, weights made from the seed, anything the program builds or finds
built, voices and inputs, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
