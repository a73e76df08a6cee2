"""The port's own kernel launches a wave, from
``cause_tpu_torch.kernels.launches`` over the traced run's window."""


def read(ctx):
    return ctx["port_launches_per_wave"]
