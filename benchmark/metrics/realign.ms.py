"""realign.ms: per CLI job, the milliseconds of the program's realignment
flushes (floria_tpu_torch/kernels/realign.py `flush_pool`): its spans
`realign.host_prep` (the Hamming precheck and the dedup),
`realign.device` (the NW, on the C++ Gotoh or K5) and `realign.scatter`
(the calls written into the reads), wherever it is called."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("realign.host_prep", "realign.device",
                         "realign.scatter"))
