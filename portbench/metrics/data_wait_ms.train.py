"""Host ms a step waits for the loader's next batch and its copy to the
device (the benchmark's span around both), the mean over the window."""


def read(ctx):
    wait = ctx.driver.data_wait
    return 1e3 * sum(wait) / len(wait) if wait else None
