"""``setup_s``: seconds from the process's start to the end of set-up
(imports, the card, the kernels' builds, the inputs, one warm unit of
every shape)."""


def read(win):
    return win["setup_s"]
