"""Device operations (kernels, copies, fills) in the traced slice over the
matrices it solved."""


def read(run):
    if run.slice is None or not run.slice.device:
        return None
    solves = sum(len(answers) for _, _, answers in run.slice.records)
    return len(run.slice.device) / solves
