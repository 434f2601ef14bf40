"""``solve_ms`` in the cells whose calls last tens of milliseconds: the
same reading, the window's length over the matrices solved in it, under
the tighter bound that such cells' steadier windows allow."""


def read(run):
    return 1e3 * run.window_s / len(run.answers)
