"""ms a matrix: the window's length over the matrices solved in it."""


def read(run):
    return 1e3 * run.window_s / len(run.answers)
