"""The card's allocated-memory peak over the window, in GiB
(``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()`` at its open)."""


def read(window):
    return window["peak_bytes"] / 2 ** 30
