"""Batched serving example on the PyTorch port: prefill + greedy decode
over request batches, with weights restorable from the burst buffer (hot
restart path).

The counterpart of ``examples/serve_lm.py`` over ``repro_torch``: it runs
``repro_torch.launch.serve`` with --reduced added, as the reference's does
(drop it on a card that holds the full config). Runs on the GPU
(``--device cuda``, the default) unless asked for the CPU:

  PYTHONPATH=src python examples/torch_serve_lm.py --arch recurrentgemma-9b \\
      --device cpu
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv and "--help" not in argv:
        argv.append("--reduced")
    serve.main(argv)


if __name__ == "__main__":
    main()
