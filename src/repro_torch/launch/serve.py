"""Serving launcher: batched prefill + greedy decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 1024 --gen 32

Port of ``repro/launch/serve.py`` with the same flags and default
(``--arch qwen2-1.5b``), plus ``--device``: the card unless ``cpu`` (or
another torch device) is named.  Weights are random from a
``torch.Generator`` seeded with ``--seed`` on that device, and so are the
prompts and a vlm's prefix embeddings or an encoder-decoder's source
frames (bf16, 0.02 * normal), drawn in that order from the one
generator.  An audio request's source has ``prompt_len`` frames, and its
cache cross K/V of as many (the reference's ``src_len=prompt_len``).

The cache holds the vlm's prefix too: ``num_prefix_embeds + prompt_len +
gen`` positions, where the reference sizes it ``prompt_len + gen``, so
that its prefill spills past the cache and decode overwrites the last
slot (``dynamic_update_slice`` clamps the write).  The port's cache
refuses a write past its end (``cache.KVCache``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.train.serve_step import decode_loop, make_serve_fns


def make_request(cfg, batch: int, prompt_len: int, seed: int, device=None):
    """(params, request): the request is {"tokens": (batch, prompt_len)
    int32} and, for a vlm, "prefix_embeds" (batch, num_prefix_embeds,
    d_model) bf16, for audio "src_embeds" (batch, prompt_len, d_model)
    bf16; all drawn from one ``torch.Generator`` seeded with ``seed`` on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = api.init_params(gen, cfg)
    request = {"tokens": torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev,
        dtype=torch.int32)}
    extra = {"vlm": ("prefix_embeds", cfg.num_prefix_embeds),
             "audio": ("src_embeds", prompt_len)}.get(cfg.family)
    if extra is not None:
        key, n = extra
        request[key] = 0.02 * torch.randn(
            (batch, n, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    return params, request


def cache_len(cfg, prompt_len: int, gen: int) -> int:
    """Positions a request's cache needs: a vlm's prefix, the prompt and
    every generated token (an encoder-decoder's source frames are no
    positions: ``init_cache``'s ``src_len``)."""
    prefix = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
    return prefix + prompt_len + gen


def init_request_cache(cfg, batch: int, prompt_len: int, gen: int,
                       dtype=torch.bfloat16, device=None):
    """A request's empty cache: ``cache_len`` positions and, for audio,
    cross K/V of the ``prompt_len`` source frames."""
    kw = {"src_len": prompt_len} if cfg.family == "audio" else {}
    return api.init_cache(cfg, batch, cache_len(cfg, prompt_len, gen),
                          dtype, device=device, **kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the GPU when not given")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params, request = make_request(cfg, args.batch, args.prompt_len,
                                   args.seed, dev)
    cache = init_request_cache(cfg, args.batch, args.prompt_len, args.gen,
                               device=dev)
    prefill_fn, _ = make_serve_fns(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    first, cache = prefill_fn(params, request, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, cache = decode_loop(params, first, cache, cfg, args.gen)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} device={dev}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch*args.gen/max(t_decode, 1e-9):.0f} tok/s)")
    print("sample continuations:", toks[:2].tolist())
    return toks


if __name__ == "__main__":
    main()
