"""Serving example on the PyTorch port: batched prefill + greedy decode.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2-1.5b
    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-130m \
        --gen 32 --device cpu

The twin of ``examples/serve_lm.py``: it runs ``repro_torch.launch.serve``
with the reduced (smoke) configs, on ``--device`` (the GPU unless ``cpu``
or another torch device is named).  Every family the port serves runs
here: ssm (mamba2-130m), dense (qwen2/2.5/3, llama3), moe (llama4-scout,
kimi-k2) and vlm (llava-next, with random prefix embeddings).
"""

import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--smoke" not in argv:
        argv.append("--smoke")
    return serve.main(argv)


if __name__ == "__main__":
    main()
