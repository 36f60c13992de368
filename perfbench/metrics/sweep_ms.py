"""Device time a traced pass of the block sweep kernel, in ms."""


def read(ev):
    return ev.kernel_ms("block_sweep_kernel")
