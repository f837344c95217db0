"""The share of the traced window in which no kernel, copy or set ran on
the card, %, from torch.profiler's device activity."""


def read(record):
    busy = record["busy_s"]
    if busy is None or not record["window_s"]:
        return None
    return (record["window_s"] - busy) / record["window_s"] * 100.0
