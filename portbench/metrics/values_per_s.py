"""values_per_s: every value returned (queries x tables) over the whole
measured window, by the host's clock."""


def read(run):
    win = run.window
    return win.steps * run.problem.queries * run.problem.ntables / win.seconds
