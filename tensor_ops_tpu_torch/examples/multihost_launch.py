#!/usr/bin/env python
"""Training in several processes: launch N local processes wired into one
run by ``init_distributed`` (the torchrun-style local launcher), each with
its own ranks, and drive the production ``fit(mesh=...)`` path: each
process's disjoint data shard, the global batch, process 0's checkpoints;
every collective between the processes' ranks is kernel 9 (over CUDA IPC
on cards, over gloo's bytes on the CPU).

    python -m tensor_ops_tpu_torch.examples.multihost_launch
        # 2 processes; on the card: 2 ranks each, all on cuda:0
    python -m tensor_ops_tpu_torch.examples.multihost_launch --procs 4 \\
        --devices-per-proc 1      # one card a process where there are 4
    python -m tensor_ops_tpu_torch.examples.multihost_launch --pipeline
        # a stage-only mesh: the staged-IR ring crosses the processes
    python -m tensor_ops_tpu_torch.examples.multihost_launch --cpu
        # CPU ranks (4 a process by default)

The parent spawns the workers and prints process 0's losses; every
process must report the same global loss curve (the batch is global, so
they all observe the one run).  On cards, process p's ranks sit on card
``p % cards``: processes that share a card take the one-shot over IPC,
processes on cards of their own the ring protocol.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKER = r'''
import json, os
import numpy as np
import torch

from tensor_ops_tpu_torch.parallel.distributed import (init_distributed,
                                                       shutdown_distributed)
info = init_distributed()   # TOPS_* env; TOPS_LOCAL_DEVICES names the ranks

from tensor_ops_tpu_torch import TorchBackend
from tensor_ops_tpu_torch.backend.rng import Rng
from tensor_ops_tpu_torch.models import (act_logistic, act_softmax, adam,
                                         cross_entropy, fit, gen_net,
                                         squared_error)
from tensor_ops_tpu_torch.parallel import make_mesh, make_pipeline_mesh

dev = os.environ["TOPS_LOCAL_DEVICES"].split(",")[0]
cpu = TorchBackend(torch.float32, "cpu")   # every process draws alike
be = TorchBackend(torch.float32, dev)
r = np.random.default_rng(0)
n_dev, n_proc = info["global_devices"], info["process_count"]
kw = dict(epochs=2, lr=0.05, optimizer=adam(), log_every=1, verbose=False,
          seed=0, checkpoint_path=os.environ["DEMO_CKPT"],
          checkpoint_every=4, chain_steps=1)


def on(net):
    from tensor_ops_tpu_torch.models import Network
    return Network(net.op, tuple(be.asarray(p.numpy()) for p in net.params),
                   net.act_names)


if os.environ.get("DEMO_MODE") == "pipeline":
    # a stage-only mesh over every process's ranks: the hand-offs between
    # stages cross the processes' boundaries; every process loads the
    # same stream
    net = on(gen_net(cpu, 32, 32, [(32, act_logistic())] * n_dev,
                     act_logistic(), Rng(cpu, seed=0)))
    X = r.uniform(0, 1, size=(256, 32))
    Y = r.uniform(0, 1, size=(256, 32))
    res = fit(net, squared_error(32), be, X, Y, batch_size=32,
              mesh=make_pipeline_mesh(n_dev), pipeline_microbatches=4, **kw)
else:
    net = on(gen_net(cpu, 64, 8, [(32, act_logistic())], act_softmax(),
                     Rng(cpu, seed=0)))
    X = r.uniform(0, 1, size=(512, 64))
    Y = np.eye(8)[r.integers(0, 8, size=512)]
    # dp = the process count keeps every data row on one process (fit
    # checks it), tp = the ranks of a process
    res = fit(net, cross_entropy(8), be, X, Y, batch_size=64,
              mesh=make_mesh(n_dev, shape=(n_proc, n_dev // n_proc)), **kw)
out = {"rank": info["process_index"], "devices": n_dev,
       "losses": [h["loss"] for h in res.history]}
print("RESULT " + json.dumps(out), flush=True)
shutdown_distributed()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="ranks a process (default: 2 on the card, 8 // "
                         "procs on the CPU)")
    ap.add_argument("--pipeline", action="store_true",
                    help="a stage-only mesh: the pipeline's hand-offs "
                         "cross the processes")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (default: the visible cards)")
    args = ap.parse_args(argv)
    if args.cpu:
        local = args.devices_per_proc or max(1, 8 // args.procs)
        devices = [["cpu"] * local] * args.procs
    else:
        import torch

        cards = torch.cuda.device_count()
        if cards == 0:
            raise SystemExit("no CUDA device is visible; pass --cpu")
        local = args.devices_per_proc or 2
        devices = [[f"cuda:{p % cards}"] * local for p in range(args.procs)]
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="tops_mh_")
    ckpt = os.path.join(tmp, "demo_ck.npz")
    procs = []
    for rank in range(args.procs):
        env = dict(os.environ)
        env.update({
            "TOPS_COORDINATOR": f"localhost:{port}",
            "TOPS_NUM_PROCESSES": str(args.procs),
            "TOPS_PROCESS_ID": str(rank),
            "TOPS_LOCAL_DEVICES": ",".join(devices[rank]),
            "DEMO_CKPT": ckpt,
            "DEMO_MODE": "pipeline" if args.pipeline else "dp_tp",
            "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                print(out)
                raise SystemExit(f"process {rank} failed (exit "
                                 f"{p.returncode})")
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    results[rank] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    r0 = results[0]
    print(f"{args.procs} processes x {local} ranks = {r0['devices']} "
          f"global ranks on {sorted({d for row in devices for d in row})}, "
          f"one mesh")
    print("process 0's losses: "
          + " ".join(f"{v:.4f}" for v in r0["losses"][:8]) + " ...")
    for rank, res in results.items():
        assert res["losses"] == r0["losses"], (
            f"process {rank} observed a different global run")
    print(f"all {args.procs} processes observed the identical global loss "
          f"curve; process 0's checkpoint at {ckpt}")


if __name__ == "__main__":
    main()
