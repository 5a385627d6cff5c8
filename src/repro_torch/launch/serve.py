"""Serving CLI, on the reduced config of the arch, on the card unless
``--device cpu`` is given: prefill + greedy decode with a KV cache (LM
archs), batched click scoring (BST), or the continuous multi-query
pattern-match server (IGPM), synchronous or under the async runtime,
traced on request — the PyTorch port of the JAX package's
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bst
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch smollm-135m --tokens 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch igpm-pem \\
      --bank 8 --steps 12 --churn 0.25 --hotspot --policy-dir /tmp/pem
  PYTHONPATH=src python -m repro_torch.launch.serve --arch igpm-pem \\
      --async --scenario flash_crowd --ticks 8 --trace --trace-out /tmp/t
  PYTHONPATH=src python -m repro_torch.launch.serve --arch igpm-pem \\
      --async --closed-loop --control frozen --control-episodes 2

``--trace`` prints the per-stage p50 breakdown; ``--trace-out PREFIX``
also writes ``PREFIX.jsonl`` (span stream), ``PREFIX.json`` (Perfetto),
``PREFIX.prom`` (Prometheus text) and flight dumps ``PREFIX.flight.*``.
``--control train|frozen`` attaches the RL serving controller to an
``--async --closed-loop`` run. Every LM arch of the registry serves
(qwen3-moe-30b-a3b, smollm-135m, deepseek-7b, qwen2-72b, dbrx-132b), and
bst; the GNN archs have no serve path, as in the reference.
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


def serve_bst(arch, device="cuda") -> None:
    """The reduced ``serve_p99`` cell scored once to warm up, then 20
    times: ms per batch and the first four click probabilities."""
    from repro_torch.launch.cells import bst_cell

    device = torch.device(device)
    reps = 20
    cell = bst_cell(arch, "serve_p99", device, smoke=True)
    with torch.no_grad():
        probs = cell.step_fn(*cell.args)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            probs = cell.step_fn(*cell.args)
        _sync(device)
    per = (time.perf_counter() - t0) / reps * 1e3
    print(f"[serve] bst p99-path batch={probs.shape[0]}: {per:.2f} ms/batch; "
          f"probs[:4]={probs[:4].cpu().numpy().round(3)}")


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


def _obs_config(args):
    """``--trace``/``--trace-out``/``--flight-n``/``--slo-ms``/
    ``--metrics-port`` → :class:`ObsConfig`. Tracing stays off unless
    asked, and writes files only under ``--trace-out``; ``--metrics-port``
    turns on the live ops surface and, with it, the per-query freshness
    ledger and the health watchdog that feed its routes."""
    from repro_torch.config.base import ObsConfig

    port = args.metrics_port
    live = port >= 0
    if not (args.trace or args.trace_out):
        return ObsConfig(freshness=live, watchdog=live, metrics_port=port)
    out = args.trace_out
    return ObsConfig(enabled=True, trace_path=out,
                     flight_n=args.flight_n,
                     flight_path=out + ".flight" if out else "",
                     slo_e2e_ms=args.slo_ms,
                     prometheus_path=out + ".prom" if out else "",
                     freshness=live, watchdog=live, metrics_port=port)


def _report_obs(server) -> None:
    """Export the configured trace artifacts and print the per-stage
    breakdown the spans bought us."""
    obs = server.obs
    if not obs.enabled:
        return
    snap = server.telemetry.snapshot()
    stages = sorted((k[len("p50_stage_"):-len("_ms")], snap[k])
                    for k in snap if k.startswith("p50_stage_"))
    if stages:
        print("[serve] stage p50 ms: "
              + " ".join(f"{name}={ms:.2f}" for name, ms in stages))
    paths = obs.export(snap)
    for kind, path in sorted(paths.items()):
        print(f"[serve] {kind}: {path}")
    if obs.flight is not None and obs.flight.n_dumps:
        print(f"[serve] flight dumps: {obs.flight.n_dumps} "
              f"(last: {obs.flight.last_path} — {obs.flight.last_reason})")


def serve_igpm(arch, steps: int, bank: int, churn: float, hotspot: bool,
               policy_dir: str = "", register=(), retire=(),
               device="cuda", obs=None, devices=None):
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
    (when one is there) and saves it after the last. ``obs`` (an
    :class:`ObsConfig`) turns on tracing. ``devices`` names the engine's
    device mesh (by default every visible device). Returns (server,
    per-step stats).
    """
    from repro_torch.config.base import ObsConfig, ServingConfig
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
    server = MatchServer(cfg, query_zoo(bank),
                         ServingConfig(obs=obs or ObsConfig()), seed=0,
                         device=device, devices=devices)
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
    _report_obs(server)
    if policy_dir:
        server.save_policy(policy_dir)
        print(f"[serve] saved PEM policy to {policy_dir} "
              f"(step {server.step_idx}, c={server.pem.c})")
    return server, stats


def serve_igpm_async(arch, scenario: str, rate: float, ticks: int,
                     bank: int, sync_too: bool = False,
                     checkpoint_dir: str = "", obs=None,
                     control: str = "off", closed_loop: bool = False,
                     control_episodes: int = 2, device="cuda",
                     devices=None):
    """Async serving runtime on a seeded workload scenario: an ingress
    thread replays the arrival process against the wall clock while the
    executor thread runs double-buffered micro-batches; match deltas
    stream to a subscriber and the closing drain flushes in-flight batches
    (whole-engine ``Engine.save`` when ``--checkpoint-dir`` names a
    directory). ``--sync-too`` replays the identical workload through the
    single-threaded reference runner first, so the two tail-latency
    snapshots print side by side. ``--closed-loop`` switches the scenario
    to ack-driven closed-loop arrivals (the summary is goodput/SLO
    violation). ``--control train|frozen|off`` attaches the RL serving
    controller: ``train`` learns during the run; ``frozen`` pre-trains
    ``--control-episodes`` closed-loop episodes under a virtual clock,
    freezes the policy, and measures pure greedy inference. Each server is
    warmed by one replay under a virtual clock and reset before its
    measured run. ``devices`` names the engine's device mesh. Returns
    (server, runtime)."""
    import dataclasses

    from repro_torch.config.base import (ControlConfig, ObsConfig,
                                         RuntimeConfig, ServingConfig)
    from repro_torch.core.query import query_zoo
    from repro_torch.runtime import (SCENARIOS, ServingRuntime, VirtualClock,
                                     WallClock, build_workload,
                                     run_closed_loop, run_workload_sync)
    from repro_torch.serving import MatchServer

    if scenario not in SCENARIOS:
        raise SystemExit(f"unknown scenario {scenario!r} "
                         f"(have: {sorted(SCENARIOS)})")
    if control != "off" and not closed_loop:
        raise SystemExit("--control wants --closed-loop (the controller's "
                         "reward is the closed-loop goodput curve)")
    sc = SCENARIOS[scenario](rate=rate, tick_s=0.05, n_ticks=ticks,
                             n_vertices=min(arch.model.n_max, 1024), seed=0,
                             closed_loop=closed_loop)
    wl = build_workload(sc, u_max=512, device=device)
    print(f"[serve] scenario={scenario} rate={rate:.0f}/s "
          f"ticks={ticks} events={wl.n_events} "
          f"duration={sc.duration_s:.1f}s")
    cfg = dataclasses.replace(arch.model, n_max=wl.graph.n_max,
                              e_max=wl.graph.e_max)
    serving = ServingConfig(microbatch_window=256, queue_depth=2048,
                            obs=obs or ObsConfig())

    def _report(tag: str, server) -> None:
        snap = server.telemetry.snapshot()
        print(f"[serve] {tag}: steps={snap['steps']} "
              f"p50_step={snap['p50_step_ms']:.1f}ms "
              f"p99_step={snap['p99_step_ms']:.1f}ms "
              f"p99_e2e={snap.get('p99_e2e_ms', 0):.1f}ms "
              f"p999_e2e={snap.get('p999_e2e_ms', 0):.1f}ms "
              f"dropped={snap['dropped_events']} "
              f"(evicted={snap['evicted_events']} "
              f"rejected={snap['rejected_events']})")

    if sync_too:
        ref = MatchServer(cfg, query_zoo(bank), serving, seed=0,
                          device=device, devices=devices)
        run_workload_sync(ref, wl, clock=VirtualClock())  # warm
        ref.reset()
        run_workload_sync(ref, wl, clock=WallClock())
        _report("sync ", ref)
    server = MatchServer(cfg, query_zoo(bank), serving, seed=0,
                         device=device, devices=devices)
    run_workload_sync(server, wl, clock=VirtualClock())  # warm
    server.reset()
    ccfg = ControlConfig(mode="train" if control != "off" else "off")
    rt = ServingRuntime(server,
                        RuntimeConfig(ingress="shed",
                                      checkpoint_dir=checkpoint_dir,
                                      control=ccfg),
                        clock=WallClock())
    if control == "frozen":
        # pre-train on deterministic closed-loop replays, then freeze:
        # the measured run below is pure greedy inference
        for _ in range(max(control_episodes, 1)):
            run_closed_loop(server, wl, clock=VirtualClock(),
                            controller=rt.controller, knobs=rt.knobs,
                            ledger=rt.acks)
            server.reset()
        print(f"[serve] controller: trained {rt.controller.n_episodes} "
              f"episodes ({rt.controller.n_decisions} decisions) — frozen")
        rt.controller.freeze()
        rt.acks.reset()
    sub = rt.subscribe()
    rt.start(wl)
    if rt.ops is not None:
        print(f"[serve] ops surface: {rt.ops.url}  "
              f"(/metrics /health /freshness /flight)")
    if not rt.join(timeout=rt.rcfg.drain_timeout_s + sc.duration_s):
        rt.stop(drain=False)
        raise TimeoutError("serving runtime did not finish the workload")
    if rt.freshness is not None:
        worst = rt.freshness.snapshot(rt.clock.now())[:3]
        print("[serve] stalest queries: " + "  ".join(
            f"{r.qid}={1e3 * r.staleness_s:.1f}ms(burn {r.burn_fast:.2f})"
            for r in worst))
    _report("async", server)
    if closed_loop:
        cs = rt.closed_summary(wl)
        print(f"[serve] closed loop: offered={cs['events_offered']:.0f} "
              f"acked={cs['events_acked']:.0f} "
              f"goodput={cs['goodput_eps']:.0f} ev/s "
              f"viol_rate={cs['viol_rate']:.3f} "
              f"(slo={cs['slo_s'] * 1e3:.0f} ms, "
              f"throttled={cs['events_throttled']:.0f})")
        if rt.controller is not None:
            print(f"[serve] controller[{rt.controller.mode}]: "
                  f"{rt.controller.n_decisions} decisions, "
                  f"knobs window={rt.knobs.window} "
                  f"depth={rt.knobs.queue_depth} "
                  f"rwr_tol={rt.knobs.rwr_tol:g}")
    deltas = sub.drain()
    new = sum(d.n_new for _, d in deltas)
    print(f"[serve] subscriber saw {len(deltas)} deltas, {new} new patterns"
          + (f"; drained checkpoint -> {checkpoint_dir}"
             if checkpoint_dir else ""))
    print(f"[serve] queue: {server.queue.stats()}")
    _report_obs(server)
    return server, rt


def parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="igpm: threaded ingress + double-buffered device "
                         "executor on a workload scenario")
    ap.add_argument("--scenario", default="flash_crowd",
                    help="igpm --async: poisson|flash_crowd|diurnal|"
                         "churn_heavy")
    ap.add_argument("--rate", type=float, default=4000.0,
                    help="igpm --async: mean event arrivals per second")
    ap.add_argument("--ticks", type=int, default=24,
                    help="igpm --async: arrival-process ticks (50 ms each)")
    ap.add_argument("--sync-too", action="store_true",
                    help="igpm --async: also run the single-threaded "
                         "reference runner for a side-by-side snapshot")
    ap.add_argument("--checkpoint-dir", default="",
                    help="igpm --async: drain checkpoints the whole "
                         "engine here via Engine.save")
    ap.add_argument("--closed-loop", action="store_true",
                    help="igpm --async: ack-driven closed-loop arrivals — "
                         "the summary is goodput/SLO-violation")
    ap.add_argument("--trace", action="store_true",
                    help="igpm: structured tracing; prints the per-stage "
                         "breakdown")
    ap.add_argument("--trace-out", default="", metavar="PREFIX",
                    help="igpm: trace export prefix (implies --trace): "
                         "PREFIX.jsonl, .json (Perfetto), .prom, .flight.*")
    ap.add_argument("--flight-n", type=int, default=16,
                    help="igpm --trace: flight-recorder ring of the last "
                         "N traced steps (dumped on crash/SLO trigger)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="igpm --trace: dump the flight ring when an e2e "
                         "latency sample exceeds this many ms (0 = off)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="igpm --async: serve the live ops surface "
                         "(/metrics /health /freshness /flight) on "
                         "127.0.0.1:PORT — 0 picks an ephemeral port, "
                         "-1 (default) disables; also enables the "
                         "per-query freshness ledger and the health "
                         "watchdog")
    ap.add_argument("--control", default="off",
                    choices=["train", "frozen", "off"],
                    help="igpm --async --closed-loop: RL serving "
                         "controller mode (frozen pre-trains "
                         "--control-episodes, then measures pure greedy "
                         "inference)")
    ap.add_argument("--control-episodes", type=int, default=2,
                    help="igpm --control frozen: closed-loop training "
                         "episodes before freezing")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    arch = get_arch(args.arch, smoke=True)
    if arch.family == "lm":
        serve_lm(arch, args.tokens, device=args.device)
    elif arch.family == "recsys":
        serve_bst(arch, device=args.device)
    elif arch.family == "igpm":
        obs = _obs_config(args)
        if args.use_async:
            serve_igpm_async(arch, args.scenario, args.rate, args.ticks,
                             args.bank, sync_too=args.sync_too,
                             checkpoint_dir=args.checkpoint_dir, obs=obs,
                             control=args.control,
                             closed_loop=args.closed_loop,
                             control_episodes=args.control_episodes,
                             device=args.device)
        else:
            if args.control != "off":
                raise SystemExit("--control wants --async --closed-loop "
                                 "(the synchronous branch has no "
                                 "controller)")
            serve_igpm(arch, args.steps, args.bank, args.churn, args.hotspot,
                       policy_dir=args.policy_dir, register=args.register,
                       retire=args.retire, device=args.device, obs=obs)
    else:
        raise SystemExit(f"{args.arch} ({arch.family}) has no serve path")


if __name__ == "__main__":
    main()
