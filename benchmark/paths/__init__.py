"""One module a kind of entry (``config["entry"]``), each with a ``Path``:
dispatch() enqueues one chunk into the program and returns a handle;
finish(handle) waits until the chunk's output is in host memory and
returns (output, valid [L, F] bool); keep(output) makes it outlive the
next chunks; decoder() is the program's BatchedDecoder (for its
StageClock).  Beside it, reference(lanes, config, k) computes chunk k
with the plain reference and compare(lanes, config, ref, output) gives
each number compared with its limit."""
