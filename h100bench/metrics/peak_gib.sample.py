"""``torch.cuda.max_memory_allocated`` over the window, in GiB: what one
request holds, which bounds the clips an operator can batch."""


def read(rec):
    if not rec.work:
        return None
    return rec.peak_bytes / 2 ** 30
