"""The 90th percentile of every step of the window, each timed from the
end of the one before (the first from the window's start), in ms."""
import numpy as np


def read(ctx):
    ends = np.asarray([ctx.t0] + ctx.ends)
    return float(np.percentile(np.diff(ends), 90) * 1e3)
