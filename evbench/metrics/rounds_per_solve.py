"""The mean of the rounds that the window's solves returned."""


def read(run):
    answers = run.answers
    return sum(a.rounds for a in answers) / len(answers)
