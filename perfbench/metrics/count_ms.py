"""Device time a traced pass of the block-label count kernel, in ms."""


def read(ev):
    return ev.kernel_ms("block_label_count_kernel")
