"""loss_ms.step: the L1/D-SSIM loss of a step, in ms: the median, over every call of
the traced run, of the CUDA-event time of the program's `fit/loss` span (the `loss_img`
call of `fit._loss_and_grads`)."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "fit/loss", "device_ms_median")
