"""Host time spent waiting for the input pipeline a training step, ms: the
program's ``densereg.pipeline.wait`` spans (the training loop's wait on the
producer threads' queue) over its ``densereg.train.step`` spans."""


def read(run):
    t = run.trace
    if t is None:
        return None
    waits = t.ranges("densereg.pipeline.wait")
    steps = t.ranges("densereg.train.step")
    if not waits or not steps:
        return None
    return sum(b - a for a, b in waits) / 1e3 / len(steps)
