"""Training data: the median host time of making a step's batch
(``GANPipeline.batch_at``) and copying it to the device."""
from bench.readers import median


def read(ctx):
    return median(ctx.spans.durations_ms("train.data"))
