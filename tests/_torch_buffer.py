"""The server ping cadence of the port tests' burst buffers that kill no
server and restore a flushed checkpoint (the reference's buffer's or the
port's).

At the buffers' default 0.25 s cadence a server whose loop stalls for ~2 s
misses three 0.6 s pings and its peers declare it dead. Under the test
suite's six workers such stalls happen. If one happens during a flush, the
flush completes among the survivors and reports the epoch durable while its
PFS copy lacks the stalled server's share (wrong bytes, or an empty
manifest), and the survivors re-replicate every key they hold. Whatever then
reads the checkpoint from the PFS alone (a fresh buffer over the same PFS
directory, a stage after an eviction) reads that copy. Injecting a 2.5 s
stall into one reference server at the flush's shuffle reproduces it. At
10 s a stall would have to outlast ~20 s. The repair is the tests' own: the
buffer's failure detector (``core/``) is unchanged.
"""
STEADY_PING_S = 10.0
