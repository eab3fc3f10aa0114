"""Tab. 8 / Tab. 14: MAC-unit hardware cost — uniform vs mixed precision.

A copy of `benchmarks/table8_hardware.py` (it computes from the paper's
table alone, on no device; the port keeps its own copy so that it imports
nothing outside its package):

    python -m repro_torch.tables.table8_hardware

Embeds the paper's synthesized MAC area/power table (TSMC 40nm @ 0.5GHz,
Tab. 14) and evaluates deployment cost models:
  * uniform W4A4 (our module-dependent scheme — single MAC type),
  * Q-ViT-style mixed precision at the same 4-bit average (the MAC array
    must provision the LARGEST bitwidth pair; power is the utilization-
    weighted average) — reproducing Tab. 8's conclusion that MDQ beats MPQ
    on hardware cost at iso average bitwidth.
"""
from __future__ import annotations

import itertools

# (a_bits, w_bits) -> (area um^2, power mW) — paper Tab. 14
MAC_TABLE = {
    (2, 2): (539.960, 0.86949), (2, 3): (551.074, 0.95939),
    (2, 4): (562.363, 1.13939), (2, 5): (571.360, 1.30085),
    (2, 6): (581.062, 1.41680), (2, 7): (597.996, 1.59534),
    (2, 8): (605.405, 1.75574), (3, 3): (571.183, 1.30043),
    (3, 4): (589.882, 1.42975), (3, 5): (602.053, 1.57912),
    (3, 6): (621.634, 1.69105), (3, 7): (638.744, 1.86085),
    (3, 8): (656.737, 1.99110), (4, 4): (608.404, 1.58901),
    (4, 5): (635.569, 1.70870), (4, 6): (660.089, 1.85997),
    (4, 7): (677.200, 1.94706), (4, 8): (702.072, 2.08973),
    (5, 5): (664.499, 1.86345), (5, 6): (695.545, 2.00091),
    (5, 7): (718.301, 2.14442), (5, 8): (749.347, 2.24832),
    (6, 6): (723.593, 2.12107), (6, 7): (770.515, 2.22367),
    (6, 8): (805.090, 2.41882), (7, 7): (817.967, 2.43294),
    (7, 8): (864.889, 2.52819), (8, 8): (893.642, 2.67960),
}


def mac(a: int, w: int):
    key = (min(a, w), max(a, w))
    return MAC_TABLE[key]


def uniform_cost(bits: int):
    return mac(bits, bits)


def mixed_cost(assignment):
    """assignment: list of (a_bits, w_bits, fraction). Area = max provisioned;
    power = utilization-weighted mean (paper Appendix E)."""
    area = max(mac(a, w)[0] for a, w, _ in assignment)
    power = sum(f * mac(a, w)[1] for a, w, f in assignment)
    return area, power


def run():
    rows = {}
    a4, p4 = uniform_cost(4)
    rows["Ours (module-dependent, uniform W4A4)"] = (a4, p4)
    # Q-ViT-style: half the layers at 2-bit, half at 6-bit (avg 4) and a
    # 3/5 split — both must provision the max MAC.
    rows["MPQ 2/6 mix (avg 4b)"] = mixed_cost([(2, 2, 0.5), (6, 6, 0.5)])
    rows["MPQ 3/5 mix (avg 4b)"] = mixed_cost([(3, 3, 0.5), (5, 5, 0.5)])
    rows["MPQ Q-ViT-like (4..8 mixed)"] = mixed_cost(
        [(4, 4, 0.55), (6, 6, 0.25), (8, 8, 0.20)])
    return rows


def main():
    rows = run()
    print(f"{'scheme':40s} {'area um^2':>10s} {'power mW':>9s}")
    for name, (a, p) in rows.items():
        print(f"{name:40s} {a:10.3f} {p:9.3f}")
    ours = rows["Ours (module-dependent, uniform W4A4)"]
    worst = max(v[0] for k, v in rows.items() if k.startswith("MPQ"))
    print(f"# uniform-MDQ area advantage vs MPQ: {worst / ours[0]:.2f}x "
          f"(paper Tab. 8: 893.6/608.4 = 1.47x)")
    return rows


if __name__ == "__main__":
    main()
