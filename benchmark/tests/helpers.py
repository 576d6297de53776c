"""Tiny sizes for running the harness's pieces on the CPU."""

import torch

#: a corpus of a few thousand titles and short windows
SHRINK = {"config": {"corpus": {"titles": 3000, "vocab_words": 2000}},
          "traffic": {"batch_size": 16, "call_batches": 1,
                      "warmup_calls": 1, "warmup_searches": 4,
                      "check_sample": 6}}


def cpu_run(name, seed=2**31 + 17, seconds=1.0, trace=False, tamper=None,
            shrink=SHRINK):
    from benchmark import run

    torch.set_num_threads(2)
    return run.run_cell(run.load_manifest(), name, seed, seconds, trace,
                        device="cpu", shrink=shrink, tamper=tamper)
