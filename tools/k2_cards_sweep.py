#!/usr/bin/env python3
"""Design sweep of K2's exchange across the cards of one host
(``exchange_kernel``), against the order it replaced.

    python3 tools/k2_cards_sweep.py [variant ...]

Builds a copy of ``spark_tpu_torch/csrc/all_to_all.cu`` per variant of
its constants (``kExchangeMinBlocks``: the blocks an SM the register
budget allows; ``kSpinNs``: how long a wait polls without sleeping) into
``build/kernels/sweep/``, and times each at the shape of shuffled q3's
largest exchange on 4 cards: per sender 6 planes of (4, 2^24) — three
int32, two int64, one bool — 7,784,628,224 B in all, random bytes from a
seeded generator on each sender's card.  The old order is timed in the
same turns: ``barrier_kernel``, ``all_to_all_kernel`` on every card,
``barrier_kernel``, from the package's own build.  Per variant:

* ``per_call_ms``: one exchange from idle cards (CUDA events on every
  card, the slowest; median of 10);
* ``b2b_ms``: 10 exchanges between one pair of events per card, per
  exchange;
* ``alone_ms``: the copy kernel under ``torch.profiler``, the slowest
  card;
* ``gather_ms``: the guards' gather (one bool per card to card 0: card 0
  copies, the others arrive and wait), 200 back to back, per exchange;
* ``timeline_us``: one call from idle cards under the profiler, per card
  the kernel's start after the first card's and its duration, and
  ``launch_gaps_us``, the host's time between the cards' launches.

The package's build is also timed with each card starting from the sender
after its own receivers (``after_own``, the old order's rule) and behind
the old order's barrier (``aligned``).  The old order's copies start from
the sender after each card's own receivers, as that order did.

Each variant is first held bit-exact against ``all_to_all_plain``.  The
tables come from ``cuda_a2a.a2a_card_plan``; every launch is made here,
without the wrapper, so the host's work is the same for every variant.
Prints the cards' names and power limits and one JSON line per variant.
Needs two cards or more and ``nvcc``; imports neither JAX nor the JAX
package.
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: each variant: the source's constants it changes (the source's own
#: values are kExchangeMinBlocks 5 and kSpinNs 4000)
VARIANTS = {
    "default": {},
    "min_blocks_3": {"kExchangeMinBlocks": 3},
    "min_blocks_4": {"kExchangeMinBlocks": 4},
    "min_blocks_6": {"kExchangeMinBlocks": 6},
    "min_blocks_8": {"kExchangeMinBlocks": 8},
    "spin_0": {"kSpinNs": 0},
}

PLANES = (("int32", 3), ("int64", 2), ("bool", 1))
CAP = 1 << 24
SHARDS = 4
GATHERS = 200


def variant_source(text, consts):
    """The kernel source with each ``constexpr int NAME = ...;`` of
    ``consts`` set to its value."""
    for name, value in consts.items():
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name}: {count} definitions in the source")
    return text


def build(name, consts):
    from spark_tpu_torch import cuda_a2a, cuda_build
    if not consts:
        return cuda_a2a._lib()
    out_dir = os.path.join(cuda_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"all_to_all_{name}.cu")
    with open(cuda_a2a.SOURCE) as f:
        text = variant_source(f.read(), consts)
    with open(src, "w") as f:
        f.write(text)
    return cuda_build.load(src, cuda_a2a._bind)


def main(names):
    import torch

    import chip_smoke as CS
    from spark_tpu_torch import cuda_a2a
    if torch.cuda.device_count() < 2:
        print("k2_cards_sweep: needs two cards or more", file=sys.stderr)
        return 2
    names = names or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cards = [torch.device("cuda", i)
             for i in range(min(SHARDS, torch.cuda.device_count()))]
    n = SHARDS
    card_of = [s * len(cards) // n for s in range(n)]
    streams = [torch.cuda.current_stream(c) for c in cards]
    cuda_a2a.enable_peer_access(cards)
    order = cuda_a2a.barrier_set(cards)
    planes = []
    for dtype, count in PLANES:
        for k in range(count):
            shards = []
            for s in range(n):
                dev = cards[card_of[s]]
                g = torch.Generator(device=dev).manual_seed(100 * k + s)
                x = torch.randint(0, 2 if dtype == "bool" else 256,
                                  (n, CAP * torch.empty(
                    (), dtype=getattr(torch, dtype)).element_size()),
                    generator=g, device=dev, dtype=torch.uint8)
                shards.append(x.view(getattr(torch, dtype)))
            planes.append(shards)
    outs = cuda_a2a.all_to_all_cards(planes, card_of, cards, streams)
    want = cuda_a2a.all_to_all_plain(planes, False, card_of, cards)
    nbytes = [sh[0].numel() * sh[0].element_size() // n for sh in planes]
    src = [[x.data_ptr() for x in sh] for sh in planes]
    dst = [[o.data_ptr() for o in per] for per in outs]
    copy_plan = cuda_a2a.a2a_card_plan(src, dst, nbytes, nbytes, card_of)
    fused_plan = cuda_a2a.a2a_card_plan(
        src, dst, nbytes, nbytes, card_of,
        cross=order.cross(cuda_a2a.BARRIER_TIMEOUT_S))
    guards = [[torch.ones((), dtype=torch.bool, device=cards[card_of[s]])
               for s in range(n)]]
    g_out = torch.empty((1, n), dtype=torch.bool, device=cards[0])
    gather_plan = cuda_a2a.a2a_card_plan(
        [[x.data_ptr() for x in guards[0]]],
        [[g_out.data_ptr()]] + [None] * (len(cards) - 1), [1], [0], card_of,
        range(1), cross=order.cross(cuda_a2a.BARRIER_TIMEOUT_S))

    def tables(plan):
        return [(d0, n_dst, (ctypes.c_longlong * len(t))(*t), total)
                for d0, n_dst, t, total in plan]

    #: host times of the last run's launches (perf_counter, s)
    stamps = []

    def fused(lib, plan, P, after_own=False, aligned=False):
        """One exchange: a launch per card.  ``after_own``: each card
        starts with the sender after its own receivers (whose items wait
        for that card), instead of its own; ``aligned``: the old order's
        barrier first, so the cards start together."""
        def run():
            if aligned:
                cuda_a2a.barrier(cards, streams)
            stamps.clear()
            for (d0, n_dst, buf, total), dev, st in zip(plan, cards,
                                                        streams):
                rot = ((d0 + n_dst) % n if after_own else
                       cuda_a2a.first_sender(n, d0, n_dst)) if n_dst else 0
                with torch.cuda.device(dev):
                    rc = lib.spark_exchange_part(
                        buf, len(buf), P, n, d0, n_dst, rot, total,
                        st.cuda_stream)
                stamps.append(time.perf_counter())
                if rc:
                    raise RuntimeError(f"exchange launch: CUDA error {rc}")
        return run

    def timeline(run, kernel):
        """One call from idle cards under the profiler: per card the
        kernel's start (us after the first card's) and its duration
        (us), and the host's launch intervals (us)."""
        from torch.profiler import ProfilerActivity, profile
        CS.sync_cards()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CS.PROFILE_LEAD_MARKERS):
                for c in cards:
                    torch.zeros(1, device=c).fill_(1.0)
            CS.sync_cards()
            time.sleep(0.05)
            run()
            CS.sync_cards()
            time.sleep(0.05)
        rec = {e.device_index: (e.time_range.start, e.time_range.elapsed_us())
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.name}
        t0 = min(v[0] for v in rec.values()) if rec else 0
        gaps = [round((b - a) * 1e6, 1) for a, b in zip(stamps, stamps[1:])]
        return {d: [round(v[0] - t0, 1), round(v[1], 1)]
                for d, v in sorted(rec.items())}, gaps

    base = cuda_a2a._lib()
    copies = tables(copy_plan)

    def old_order():
        cuda_a2a.barrier(cards, streams)
        for (d0, n_dst, buf, total), dev, st in zip(copies, cards, streams):
            with torch.cuda.device(dev):
                rc = base.spark_all_to_all_part(
                    buf, len(buf), len(planes), n, d0, n_dst,
                    (d0 + n_dst) % n, total, st.cuda_stream)
            if rc:
                raise RuntimeError(f"copy launch: CUDA error {rc}")
        cuda_a2a.barrier(cards, streams)

    def equal():
        CS.sync_cards()
        return all(torch.equal(g, w) for gs, ws in zip(outs, want)
                   for g, w in zip(gs, ws))

    def measure(run, kernel, gather=None):
        for o in outs:
            for x in o:
                x.zero_()
        run()
        ok = equal()
        per_call = statistics.median(
            CS._cards_timed(cards, streams, run, 1) for _ in range(10))
        b2b = CS._cards_timed(cards, streams,
                              lambda: [run() for _ in range(10)], 10)
        alone = max(CS._kernel_ms_by_card(run, kernel).values())
        g_ms = None
        if gather is not None:
            gather()
            CS.sync_cards()
            g_ms = CS._cards_timed(
                cards, streams, lambda: [gather() for _ in range(GATHERS)],
                GATHERS)
        line, gaps = timeline(run, kernel)
        return {"equal": ok, "per_call_ms": per_call, "b2b_ms": b2b,
                "alone_ms": alone, "gather_ms": g_ms,
                "timeline_us": line, "launch_gaps_us": gaps}

    results = []
    libs = {name: build(name, VARIANTS[name]) for name in names}
    fused_tables, gather_tables = tables(fused_plan), tables(gather_plan)
    for turn in range(2):
        got = measure(old_order, "all_to_all_kernel")
        got.update(variant="old order", turn=turn)
        print(json.dumps(got), flush=True)
        results.append(got)
        for name in (names if turn == 0 else list(reversed(names))):
            lib = libs[name]
            got = measure(fused(lib, fused_tables, len(planes)),
                          "exchange_kernel", fused(lib, gather_tables, 1))
            got.update(variant=name, consts=VARIANTS[name], turn=turn)
            print(json.dumps(got), flush=True)
            results.append(got)
        # the package's build, each card from its own senders first, and
        # started together behind the old order's barrier
        for how in ("after_own", "aligned"):
            got = measure(fused(base, fused_tables, len(planes),
                                after_own=how == "after_own",
                                aligned=how == "aligned"),
                          "exchange_kernel")
            got.update(variant=how, turn=turn)
            print(json.dumps(got), flush=True)
            results.append(got)
    order.check()
    bad = [r for r in results if not r["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
