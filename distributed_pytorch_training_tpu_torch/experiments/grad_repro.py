"""Is a training step's gradient reproducible on the card, and with
``--remat``? Two checks, on CUDA:

    python3 distributed_pytorch_training_tpu_torch/experiments/grad_repro.py \\
        [--out FILE]

* ``lookups``: an embedding lookup's table gradient computed 4 times from
  the same inputs, by formulation (``F.embedding``, ``index_select``, a
  one-hot product) and index pattern (BERT's type table: 4096 lookups of
  row 0 of 2; a token table with 500, 2000 or 3000 repeats of one id),
  with ``torch.use_deterministic_algorithms`` off and on (the one-hot
  product off only): how many of the repeats equal the first, bitwise.
* ``bert``: one BERT-base masked-LM loss-and-backward at full width
  (batch 8 x 512, fp32, the flash kernels and the einsum attention), run
  twice plainly and twice with ``remat``: for each pair, whether the loss
  is bitwise equal and which gradient leaves differ (with the worst
  max|diff| / max|g|); once with the type table looked up as the model
  does it (a one-hot product), once through ``F.embedding``.

Prints one JSON object: the card and both checks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPEATS = 4


def _lookups(torch) -> list:
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def ids_with(repeats: int, n: int, rows: int):
        rest = torch.randint(0, rows, (n - repeats,), generator=g,
                             device=dev)
        return torch.cat([torch.full((repeats,), 103, device=dev), rest])

    cases = {"type: 4096 x row 0 of 2": (
                 torch.zeros(4096, dtype=torch.long, device=dev), 2)}
    for repeats in (500, 2000, 3000):
        cases[f"token: {repeats} x one id of 4096"] = (
            ids_with(repeats, 4096, 30522), 30522)

    def grad(ids, rows, how):
        table = torch.randn((rows, 768), generator=torch.Generator(
            device=dev).manual_seed(1), device=dev).requires_grad_()
        up = torch.randn((ids.numel(), 768), generator=torch.Generator(
            device=dev).manual_seed(2), device=dev)
        if how == "embedding":
            out = F.embedding(ids, table)
        elif how == "index_select":
            out = table.index_select(0, ids)
        else:
            out = F.one_hot(ids, rows).float() @ table
        return torch.autograd.grad(out, table, up)[0]

    out = []
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        try:
            for name, (ids, rows) in cases.items():
                for how in ("embedding", "index_select", "one_hot"):
                    # the product is a GEMM: cuBLAS under the
                    # deterministic flag wants CUBLAS_WORKSPACE_CONFIG,
                    # which would change the BERT check's GEMMs
                    if how == "one_hot" and (rows > 2 or deterministic):
                        continue
                    first = grad(ids, rows, how)
                    same = sum(torch.equal(first, grad(ids, rows, how))
                               for _ in range(REPEATS - 1))
                    out.append({"deterministic": deterministic,
                                "case": name, "formulation": how,
                                "repeats_equal": f"{same + 1} of {REPEATS}"})
        finally:
            torch.use_deterministic_algorithms(False)
    return out


def _bert(torch) -> list:
    import numpy as np

    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.models.layers import Embed
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        MaskedLMTask,
        StepKey,
    )
    from distributed_pytorch_training_tpu_torch.utils import prng

    dev = torch.device("cuda", 0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 30522, (8, 512)).astype(np.int32)).to(dev)
    batch = {"input_ids": ids, "weight": torch.ones(8, device=dev)}
    task, key = MaskedLMTask(), StepKey(prng.prng_key(5))

    def step(remat: bool, attention: str):
        kw = ({"attention_fn": make_flash_attention_fn(False)}
              if attention == "flash" else {})
        model = get_model("bert_base", remat=remat, **kw)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev)
        loss, _, _ = task.loss_and_metrics(model, batch, True, None, key)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out = loss.detach(), dict(zip(names, grads))
        del model
        return out

    def compare(a, b) -> dict:
        (la, ga), (lb, gb) = a, b
        diff = {n: ((ga[n] - gb[n]).abs().max()
                    / ga[n].abs().max().clamp(min=1e-30)).item()
                for n in ga if not torch.equal(ga[n], gb[n])}
        return {"loss_equal": torch.equal(la, lb), "leaves": len(ga),
                "leaves_differ": sorted(diff.items(), key=lambda t: -t[1])}

    out = []
    one_hot = Embed.one_hot_lookup
    for type_lookup in ("one_hot", "embedding"):
        if type_lookup == "embedding":
            Embed.one_hot_lookup = Embed.forward
        try:
            for attention in ("flash", "xla"):
                plain = [step(False, attention) for _ in range(2)]
                remat = [step(True, attention) for _ in range(2)]
                for pair, (a, b) in (("plain vs plain", plain),
                                     ("remat vs remat", remat),
                                     ("plain vs remat",
                                      (plain[0], remat[0]))):
                    out.append({"type_lookup": type_lookup,
                                "attention": attention, "pair": pair,
                                **compare(a, b)})
                del plain, remat
                torch.cuda.empty_cache()
        finally:
            Embed.one_hot_lookup = one_hot
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("grad_repro: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from distributed_pytorch_training_tpu_torch.ops import build
    from distributed_pytorch_training_tpu_torch.ops.flash_attention import (
        LIBRARY,
    )

    build.build_all([LIBRARY])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    line = json.dumps({"card": card, "lookups": _lookups(torch),
                       "bert": _bert(torch)})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
