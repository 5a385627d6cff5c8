"""Serving CLI, on the reduced config of the arch, on the card unless
``--device cpu`` is given: prefill + greedy decode with a KV cache (LM
archs), or the continuous multi-query pattern-match server (IGPM) — the
LM branch and the synchronous IGPM branch of the JAX package's
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch igpm-pem \\
      --bank 8 --steps 12 --churn 0.25 --hotspot --policy-dir /tmp/pem

The IGPM flags of features not ported yet (the async runtime, the serving
controller, tracing and the ops surface) are refused with the ROADMAP.md
item that brings them; the BST branch is not ported.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.config.registry import get_arch, list_archs
from repro_torch.models.transformer import Cache, Params, TransformerLM

PROMPT_LEN = 12


@dataclass
class Generation:
    tokens: torch.Tensor      # (B, tokens_out) greedy continuation, int32
    logits: torch.Tensor      # (B, 1, V) logits of the last step
    cache: Cache              # (L, B, prompt + tokens_out, KV, hd) ×2, bf16
    prefill_s: float          # prefill + cache pad, wall clock
    decode_s: float           # the tokens_out - 1 decode steps, wall clock


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model: TransformerLM, params: Params,
                    prompt: torch.Tensor, tokens_out: int) -> Generation:
    """Prefill ``prompt`` (B, P), pad the cache to P + tokens_out, then
    decode greedily: the first token comes from the prefill logits, each of
    the other ``tokens_out - 1`` from one decode step."""
    B, P = prompt.shape
    t0 = time.perf_counter()
    logits, (ks, vs) = model.prefill(params, prompt)
    pad = tokens_out
    ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
    vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    _sync(prompt.device)
    prefill_s = time.perf_counter() - t0

    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(tokens_out - 1):
        logits, (ks, vs) = model.decode_step(params, tok, (ks, vs), P + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    _sync(prompt.device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1), logits, (ks, vs), prefill_s,
                      decode_s)


def serve_lm(arch, tokens_out: int, batch: int = 2,
             device="cuda") -> Generation:
    cfg = arch.model
    model = TransformerLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (batch, PROMPT_LEN),
                           generator=torch.Generator(device=device)
                           .manual_seed(1), device=device)
    gen = greedy_generate(model, params, prompt, tokens_out)
    print(f"[serve] prefill {tuple(prompt.shape)} in {gen.prefill_s:.2f}s")
    print(f"[serve] decoded {tokens_out} tokens/seq × {batch} seqs "
          f"in {gen.decode_s:.2f}s "
          f"({tokens_out * batch / max(gen.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] greedy continuation (row 0): "
          f"{gen.tokens[0, :16].cpu().numpy()}")
    return gen


def _parse_membership_events(register, retire):
    """``--register STEP:SHAPE`` / ``--retire STEP:QID`` → {step: [action]}."""
    events = {}
    for kind, specs in (("register", register or ()),
                        ("retire", retire or ())):
        for item in specs:
            step_s, _, arg = item.partition(":")
            if not arg:
                raise SystemExit(
                    f"--{kind} wants STEP:"
                    f"{'SHAPE' if kind == 'register' else 'QID'}, "
                    f"got {item!r}")
            events.setdefault(int(step_s), []).append((kind, arg))
    return events


def _occupancy_str(server) -> str:
    return " ".join(f"{q}x{qe}x{b}:{live}/{pad}"
                    for (q, qe, b), (live, pad)
                    in sorted(server.occupancy().items()))


def serve_igpm(arch, steps: int, bank: int, churn: float, hotspot: bool,
               policy_dir: str = "", register=(), retire=(),
               device="cuda"):
    """Continuous multi-query match serving on a synthetic churn stream.

    One MatchServer (the default ``ServingConfig()``: adaptive PEM) serves
    a ``bank``-sized standing-query zoo against a generated update stream
    (deletion traffic via ``--churn``, periodic bursts via ``--hotspot``);
    per-step match deltas, per-bucket occupancy, and the closing telemetry
    snapshot are printed. Scripted membership events exercise the engine's
    dynamic banks:

      --register 3:triangle   register a triangle at step 3 (also: square,
                              star5, clique4 — repeatable)
      --retire 5:triangle#1   retire a query by qid at step 5 (qids are
                              printed when registered)

    ``--policy-dir`` restores the learned PEM policy before the first step
    (when one is there) and saves it after the last. Returns (server,
    per-step stats).
    """
    from repro_torch.config.base import ServingConfig
    from repro_torch.core.query import (clique4, query_zoo, square, star5,
                                        triangle)
    from repro_torch.data.temporal import TemporalGraphSpec, generate_stream
    from repro_torch.serving import MatchServer

    shapes = {"triangle": triangle, "square": square, "star5": star5,
              "clique4": clique4}
    membership = _parse_membership_events(register, retire)

    cfg = arch.model
    n = min(cfg.n_max, 1024)
    spec = TemporalGraphSpec("serve", "sparse_dense", n_vertices=n,
                             n_edges=8 * n, n_steps=64, seed=0,
                             churn=churn, hotspot=hotspot)
    stream = generate_stream(spec, n_measured_steps=steps, u_max=512,
                             n_max=cfg.n_max, e_max=cfg.e_max, device=device)
    server = MatchServer(cfg, query_zoo(bank), ServingConfig(), seed=0,
                         device=device)
    print(f"[serve] buckets: {_occupancy_str(server)}")
    if policy_dir:
        try:
            at = server.load_policy(policy_dir)
            print(f"[serve] restored PEM policy from {policy_dir} "
                  f"(step {at}, c={server.pem.c})")
        except FileNotFoundError:
            print(f"[serve] no policy in {policy_dir} — starting fresh")

    g = stream.graph
    stats = []
    for t, upd in enumerate(stream.updates):
        for kind, arg in membership.get(t, ()):
            if kind == "register":
                if arg not in shapes:
                    raise SystemExit(f"unknown query shape {arg!r} "
                                     f"(have: {sorted(shapes)})")
                qid = server.register(shapes[arg]())
                print(f"[serve] step {t}: registered {arg} as qid={qid}  "
                      f"buckets: {_occupancy_str(server)}")
            else:
                server.retire(arg)
                print(f"[serve] step {t}: retired qid={arg}  "
                      f"buckets: {_occupancy_str(server)}")
        server.submit_update(upd)
        g, st = server.step(g)
        stats.append(st)
    for st in stats:
        top = (max(st.deltas, key=lambda d: d.n_new) if st.deltas else None)
        top_s = f"top={top.query}(+{top.n_new})" if top else "no live queries"
        print(f"[serve] step {st.step}: {st.elapsed * 1e3:6.1f} ms  "
              f"events={st.n_events:4d} recompute={st.n_recompute:5d} "
              f"new={st.n_new_patterns:3d} pruned={st.n_pruned:2d} "
              f"c={st.community_size} loss={st.rl_loss:.4g}  {top_s}")
    snap = server.telemetry.snapshot()
    print(f"[serve] bank={len(server.queries)} steps={snap['steps']} "
          f"p50={snap['p50_step_ms']:.1f}ms p99={snap['p99_step_ms']:.1f}ms "
          f"{snap['updates_per_s']:.0f} upd/s {snap['patterns_per_s']:.1f} "
          f"pat/s recompute={snap['recompute_frac']:.2f}")
    print(f"[serve] buckets: {_occupancy_str(server)}")
    print(f"[serve] queue: {server.queue.stats()}")
    if policy_dir:
        server.save_policy(policy_dir)
        print(f"[serve] saved PEM policy to {policy_dir} "
              f"(step {server.step_idx}, c={server.pem.c})")
    return server, stats


# IGPM flags of the reference CLI whose features are not ported yet: dest →
# (flag, default, the ROADMAP.md queue-1 item that brings it). A flag set
# away from its default is refused, never ignored.
_WAITING_FLAGS = {
    "use_async": ("--async", False, "9, runtime"),
    "scenario": ("--scenario", "flash_crowd", "9, runtime"),
    "rate": ("--rate", 4000.0, "9, runtime"),
    "ticks": ("--ticks", 24, "9, runtime"),
    "sync_too": ("--sync-too", False, "9, runtime"),
    "checkpoint_dir": ("--checkpoint-dir", "", "9, runtime"),
    "closed_loop": ("--closed-loop", False, "9, runtime"),
    "control": ("--control", "off", "10, control"),
    "control_episodes": ("--control-episodes", 2, "10, control"),
    "trace": ("--trace", False, "11, observability"),
    "trace_out": ("--trace-out", "", "11, observability"),
    "flight_n": ("--flight-n", 16, "11, observability"),
    "slo_ms": ("--slo-ms", 0.0, "11, observability"),
    "metrics_port": ("--metrics-port", -1, "11, observability"),
}


def _refuse_waiting_flags(args) -> None:
    for dest, (flag, default, item) in _WAITING_FLAGS.items():
        if getattr(args, dest) != default:
            raise SystemExit(f"{flag} asks for a feature that is not ported "
                             f"yet — see ROADMAP.md queue 1, item {item}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=8,
                    help="igpm: serving steps to run")
    ap.add_argument("--bank", type=int, default=4,
                    help="igpm: number of standing queries")
    ap.add_argument("--churn", type=float, default=0.25,
                    help="igpm: removals per step as a fraction of adds")
    ap.add_argument("--hotspot", action="store_true",
                    help="igpm: periodic burst steps on a hot region")
    ap.add_argument("--policy-dir", default="",
                    help="igpm: persist/restore the PEM policy here")
    ap.add_argument("--register", action="append", default=[],
                    metavar="STEP:SHAPE",
                    help="igpm: register a standing query mid-stream "
                         "(triangle|square|star5|clique4); repeatable")
    ap.add_argument("--retire", action="append", default=[],
                    metavar="STEP:QID",
                    help="igpm: retire a standing query mid-stream; "
                         "repeatable")
    for dest, (flag, default, item) in _WAITING_FLAGS.items():
        kw = ({"action": "store_true"} if default is False
              else {"type": type(default), "default": default})
        ap.add_argument(flag, dest=dest,
                        help=f"igpm: not ported yet (ROADMAP.md queue 1, "
                             f"item {item})", **kw)
    args = ap.parse_args(argv)
    arch = get_arch(args.arch, smoke=True)
    if arch.family == "lm":
        serve_lm(arch, args.tokens, device=args.device)
    elif arch.family == "igpm":
        _refuse_waiting_flags(args)
        serve_igpm(arch, args.steps, args.bank, args.churn, args.hotspot,
                   policy_dir=args.policy_dir, register=args.register,
                   retire=args.retire, device=args.device)
    else:
        raise SystemExit(f"{args.arch} ({arch.family}) has no serve path "
                         f"in the port yet (see ROADMAP.md)")


if __name__ == "__main__":
    main()
