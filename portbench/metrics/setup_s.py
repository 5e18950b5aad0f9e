"""setup_s: process start to the first timed step (host clock): loading,
the weights and inputs made on the card, building or loading the kernels,
the graph captures and the warm-up."""


def read(w):
    return w.setup_s
