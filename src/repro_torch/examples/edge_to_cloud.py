"""Edge-to-cloud placement (port of examples/edge_to_cloud.py, paper
§5.2.1): a tiny on-device ensemble answers agreed requests locally; only
disagreements cross the network.  Uses the paper's delay grid and trained
tier models at the reference's widths: head size 16 at the edge (d 32, 2
heads), 32 in the cloud (d 128, 4 heads).

    PYTHONPATH=src python -m repro_torch.examples.edge_to_cloud [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import deferral
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.core.cost_model import EDGE_DELAYS, EdgeCloudCost
from repro_torch.data import MixtureTask
from repro_torch.device import resolve_device
from repro_torch.examples.train_then_cascade import calibrate, stack_members, train_classifier
from repro_torch.models.params import tree_map
from repro_torch.optim import OptimConfig
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, edge_cloud

EDGE = ModelConfig(name="edge", family="dense", n_layers=1, d_model=32, d_ff=64,
                   vocab_size=256, n_heads=2, n_kv_heads=2, remat=False)
CLOUD = ModelConfig(name="cloud", family="dense", n_layers=3, d_model=128, d_ff=256,
                    vocab_size=256, n_heads=4, n_kv_heads=4, remat=False)
TASK = MixtureTask(vocab=256, n_classes=16, seq_len=32, easy_frac=0.6, seed=0)
WALL_LINK_DELAY_S = 0.04  # the overlapped path's wall-clock link


def train_tiers(args, device):
    """The edge ensemble (3 members, seeds 0-2) and the cloud model (seed
    9): (stacked edge values, cloud values with a member axis)."""
    ocfg = OptimConfig(lr=2e-3)
    train = lambda cfg, steps, seed: train_classifier(cfg, TASK, steps, seed, device, ocfg, log_every=0)[0]  # noqa: E731
    edge = stack_members([train(EDGE, args.edge_steps, s) for s in (0, 1, 2)])
    return edge, tree_map(lambda t: t[None], train(CLOUD, args.cloud_steps, 9))


def tiers(edge, cloud, theta, device):
    return [
        CascadeTier(EDGE, edge, TierSpec("edge", "vote", theta, k=3, cost=1.0), device=device),
        CascadeTier(CLOUD, cloud, TierSpec("cloud", "confidence", -1.0, k=1, cost=50.0), device=device),
    ]


def classify_over_link(edge, cloud, theta, toks, device):
    """Classify ``toks`` through the cascade placed by ``edge_cloud(delay=
    "medium")``: (result, the edge -> cloud link)."""
    placement = edge_cloud(delay="medium")
    server = CascadeServer(tiers(edge, cloud, theta, device), device=device, placement=placement)
    with torch.no_grad():
        res = server.classify(toks)
    return res, placement


def requests():
    rng = np.random.default_rng(3)
    return [Request(tokens=rng.integers(0, 256, 8).astype(np.int32), max_new_tokens=6) for _ in range(12)]


def serve_over_link(server_tiers, link_kind, device, delay=WALL_LINK_DELAY_S):
    """``serve_continuous`` of ``requests()`` over an ``edge_cloud`` link
    of ``link_kind``: (completed requests, wall seconds, the link)."""
    pl = edge_cloud(delay=delay, link=link_kind)
    srv = CascadeServer(server_tiers, device=device, placement=pl)
    with torch.no_grad():
        t0 = time.perf_counter()
        done = srv.serve_continuous(requests(), ServeConfig(n_slots=4, max_seq=32))
        if device.type == "cuda":
            torch.cuda.synchronize()
    return done, time.perf_counter() - t0, pl.link(0)


def generations(done):
    return {tuple(r.tokens): tuple(r.output) for r in done}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge-steps", type=int, default=200)
    ap.add_argument("--cloud-steps", type=int, default=400)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    print("training edge ensemble (3x tiny) and cloud model ...")
    edge, cloud = train_tiers(args, device)
    theta, _ = calibrate(edge, EDGE, TASK, seed=77)

    test_toks, test_y, _ = TASK.sample(2048, seed=42)
    with torch.no_grad():
        out = deferral.vote_rule(ens.ensemble_last_logits(edge, {"tokens": test_toks}, EDGE), theta)
        cloud_pred = ens.ensemble_last_logits(cloud, {"tokens": test_toks}, CLOUD)[0].argmax(-1).cpu().numpy()
    defer = out.defer.cpu().numpy()
    pred = np.where(defer, cloud_pred, out.pred.cpu().numpy())
    print(f"\ndefer rate: {defer.mean():.2f}  "
          f"accuracy: ABC {(pred == test_y).mean():.3f} vs cloud-only "
          f"{(cloud_pred == test_y).mean():.3f}")
    print(f"{'delay tier':12s} {'ABC latency':>12s} {'cloud-only':>12s} {'reduction':>10s}")
    for name, delay in EDGE_DELAYS.items():
        cm = EdgeCloudCost(delay=delay)
        a, c = cm.mean_latency(defer.mean()), cm.mean_latency(1.0)
        print(f"{name:12s} {a * 1e3:10.3f}ms {c * 1e3:10.3f}ms {c / a:9.1f}x")

    # -- the same boundary as a runtime object: place the tiers on simulated
    # edge/cloud hosts and let the serving path meter what actually crosses
    res, placement = classify_over_link(edge, cloud, theta, test_toks[:256], device)
    link = placement.link(0)
    full_bytes = 256 * test_toks.shape[1] * 4
    print(f"\nmeasured over the edge->cloud link ({placement.describe()}):")
    print(f"  deferred {link.total_examples}/256 requests, "
          f"{link.total_bytes / 1e3:.1f} kB crossed vs {full_bytes / 1e3:.1f} kB "
          f"always-cloud ({full_bytes / max(1, link.total_bytes):.1f}x reduction), "
          f"simulated link time {link.total_latency * 1e3:.1f} ms")

    # -- the overlapped path: continuous serving over a REAL (wall-clock)
    # link, once blocking on every deferral hop and once with the edge tier
    # decoding while payloads are in flight.  Same generations, same metered
    # hops: only the makespan changes.
    shared = tiers(edge, cloud, theta, device)
    done_sim, _, _ = serve_over_link(shared, "sim", device)  # first run (captures on the card) off the clock
    done_ser, wall_ser, ser = serve_over_link(shared, "serial", device)
    done_ovl, wall_ovl, ovl = serve_over_link(shared, "async", device)
    same = generations(done_ser) == generations(done_ovl)
    print(f"\noverlapped serving over a {WALL_LINK_DELAY_S * 1e3:.0f}ms wall-clock link "
          f"({ovl.total_examples} deferrals):")
    print(f"  makespan {wall_ser * 1e3:.0f} ms serial -> {wall_ovl * 1e3:.0f} ms "
          f"overlapped = {wall_ser / wall_ovl:.2f}x overlap ratio; "
          f"{(ovl.total_latency - ovl.total_wait) * 1e3:.0f} ms of link time hidden "
          f"behind edge decode; generations identical: {same}")
    return dict(edge=edge, cloud=cloud, theta=theta, defer=defer, pred=pred, tokens=test_toks,
                link_result=res, link=link, served={"sim": done_sim, "serial": done_ser, "async": done_ovl},
                links={"serial": ser, "async": ovl}, walls={"serial": wall_ser, "async": wall_ovl},
                generations_identical=same)


if __name__ == "__main__":
    main()
