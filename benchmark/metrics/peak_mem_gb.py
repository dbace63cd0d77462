"""The allocator's peak over the window: torch.cuda.max_memory_allocated()
after a reset at the window's start, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.window_peak_bytes / 1e9 if ctx.window_peak_bytes else None
