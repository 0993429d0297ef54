"""peak_mem_gib.train: `torch.cuda.max_memory_allocated` over the train
state's set-up steps and the window's, in GiB."""


def read(layer):
    peak = layer.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
