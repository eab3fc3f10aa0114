"""Tab. 2: SDAM of activations, ConvNets against transformers (twin of
`benchmarks/table2_sdam.py`).

A small ConvNet (the paper compares ResNet / VGG against ViT / DeiT / Swin)
and a reduced transformer run on random inputs; the table reports the mean
SDAM over module activations. The paper's ordering is SDAM(transformer) >
SDAM(ConvNet). Also the Tab. 6 direction: training with MDQ lowers SDAM
against LSQ. The ConvNet runs on `torch.nn.functional.conv2d` (NCHW), its
SDAM taken over the channel axis.

    python -m repro_torch.tables.table2_sdam [--device cpu] [--steps N]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.policy import QuantConfig
from repro_torch.core.sdam import mean_sdam
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.tables.common import (bench_model, cli_args, default_tcfg,
                                       train_eval)


def convnet_activations(gen: torch.Generator, x: torch.Tensor) -> list:
    """3-block CNN (conv, per-channel standardization, relu, 2x2 max
    pool) over x (N, C, H, W); the blocks' activations. The
    standardization is BatchNorm at init: it equalizes channel statistics,
    which is why a ConvNet's SDAM is low while layernorm transformers keep
    their cross-channel variation."""
    acts = []
    chan = [x.shape[1], 16, 32, 64]
    for i in range(3):
        w = torch.randn((chan[i + 1], chan[i], 3, 3), generator=gen,
                        device=x.device) * (2.0 / (9 * chan[i])) ** 0.5
        x = F.conv2d(x, w, padding=1)
        mu = torch.mean(x, dim=(0, 2, 3), keepdim=True)
        sd = torch.std(x, dim=(0, 2, 3), keepdim=True, correction=0) + 1e-5
        x = F.max_pool2d(torch.relu((x - mu) / sd), 2)
        acts.append(x)
    return acts


def transformer_sdam(gen: torch.Generator, cfg, tokens, device) -> float:
    qcfg = QuantConfig(mode="off")
    params = M.init_params(cfg, qcfg, gen, device)
    with torch.no_grad():
        _, aux = M.forward(params, {"tokens": tokens}, cfg, qcfg)
    return float(aux["act_sdam"])


def run(steps: int = 40, device=None):
    """{"convnet", "transformer", "trained_mdq", "trained_lsq"}: mean SDAM
    of each (`steps`: the two QAT runs' length, the reference's 40)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    img = torch.randn((4, 3, 32, 32), generator=gen, device=device)
    conv = [a.movedim(1, -1) for a in convnet_activations(gen, img)]
    conv_sdam = float(mean_sdam(conv))

    cfg = bench_model("qwen1.5-0.5b")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                           device=device)
    tr_sdam = transformer_sdam(gen, cfg, tokens, device)

    tcfg = default_tcfg()
    q_mdq = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    q_lsq = QuantConfig(w_bits=4, a_bits=4, mode="lsq")
    _, st_mdq = train_eval(cfg, q_mdq, tcfg, steps=steps, device=device)
    _, st_lsq = train_eval(cfg, q_lsq, tcfg, steps=steps, device=device)

    def trained_sdam(state, qcfg):
        with torch.no_grad():
            _, aux = M.forward(state["params"], {"tokens": tokens}, cfg, qcfg)
        return float(aux["act_sdam"])

    return {"convnet": conv_sdam, "transformer": tr_sdam,
            "trained_mdq": trained_sdam(st_mdq, q_mdq),
            "trained_lsq": trained_sdam(st_lsq, q_lsq)}


def main(argv=None):
    args = cli_args(argv, 40)
    r = run(args.steps, args.device)
    print(f"{'model':14s} SDAM")
    print(f"{'ConvNet-3':14s} {r['convnet']:.4e}")
    print(f"{'Transformer':14s} {r['transformer']:.4e}")
    print(f"{'QAT w/ MDQ':14s} {r['trained_mdq']:.4e}")
    print(f"{'QAT w/ LSQ+':14s} {r['trained_lsq']:.4e}")
    print(f"# paper ordering: transformer > convnet -> "
          f"{'OK' if r['transformer'] > r['convnet'] else 'VIOLATED'}")
    return r


if __name__ == "__main__":
    main()
