"""Device ms per UNet evaluation in the program's spans ``fyc.unet.full``,
``fyc.unet.half`` and ``fyc.unet.frame`` (each UNet call of
``AnimationPipeline.denoise``), the kernels' own spans nested in them
included, over their calls: ``unet_eval_ms.sample`` read from inside."""

from h100bench.harness import spans

ranges = spans.ranges


def read(rec):
    return spans.ms_per_call(rec, "fyc.unet.")
