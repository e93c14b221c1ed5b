"""backward_ms.step: autograd's backward of a step, in ms: the median, over every
call of the traced run, of the CUDA-event time of the program's `fit/backward` span
(`torch.autograd.grad` in `fit._loss_and_grads`: the blend adjoint K5, the other adjoints and
autograd's sums)."""

from gpubench import program_spans

program_spans.enable()


def read(run):
    return program_spans.span_ms(run, "fit/backward", "device_ms_median")
