"""One rank of tests/test_torch_dist_procs.py's two-process group.

Usage: python tests/_torch_dist_worker.py RANK WORLD PORT CLI_PORT FLUSH_PORT
STOP_PORT RESUME_PORT OUT PxS [DEVICE]

Joins a gloo group of WORLD ranks at tcp://127.0.0.1:PORT on DEVICE (cpu,
the default, or cuda: every rank on the one card, gloo carrying CUDA
tensors), renders `reference` at 32x24 over a PxS mesh with
parallel.render_sharded_megakernel and parallel.render_sharded, then
leaves the group and runs the CLI under --mesh PxS on DEVICE, each run in
its own group from PT_COORDINATOR: with a checkpoint (CLI_PORT); with a
flush after every segment (PT_FLUSH_S=0, FLUSH_PORT); with the checkpoint
of OUT.stop.ck.npz and rank 0 failing at chunk 2 until it gives up
(STOP_PORT); then resumed from it with rank 1 failing once at chunk 3
(RESUME_PORT). Each rank names its own checkpoint, so rank 1 has none to
resume from. Writes the two frames, the collectives' times and what each
stopped run raised to OUT (.npz); rank 0's CLI writes OUT.raw,
OUT.flush.raw, OUT.resume.raw and OUT.resume.json. Imports no JAX.
"""
import os
import sys

(rank, world, port, cli_port, flush_port, stop_port, resume_port, out,
 mesh_arg) = sys.argv[1:10]
device = sys.argv[10] if len(sys.argv) > 10 else "cpu"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from pathtracer_tpu_torch import cli  # noqa: E402
from pathtracer_tpu_torch.config import RenderConfig  # noqa: E402
from pathtracer_tpu_torch.parallel import (initialize_multihost,  # noqa: E402
                                           make_mesh, render_sharded,
                                           render_sharded_megakernel)
from pathtracer_tpu_torch.parallel.mesh import (COLLECTIVE_S,  # noqa: E402
                                                parse_mesh)
from pathtracer_tpu_torch.scenes import get_scene  # noqa: E402

shape = parse_mesh(mesh_arg)
os.environ["PT_DIST_BACKEND"] = "gloo"
dev = initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                           device_type=device, timeout_s=120)
assert dev.type == device and dist.get_backend() == "gloo"
mesh = make_mesh(shape)
cfg = RenderConfig(width=32, height=24, samples=4, samples_per_pass=2)
sc = get_scene("reference", cfg)
arrays, meta = sc.pack(device=dev)
mega = render_sharded_megakernel(arrays, meta, sc.camera, cfg, mesh)
wave = render_sharded(arrays, meta, sc.camera, cfg, mesh)
times = dict(COLLECTIVE_S)
# a flag one rank raises holds on every rank
agree = list(mesh.any(rank == "0", False))
dist.destroy_process_group()

os.environ.update(PT_COORDINATOR=f"127.0.0.1:{cli_port}",
                  PT_NUM_PROCESSES=world, PT_PROCESS_ID=rank)
rc = cli.main(["--scene", "reference", "--width", "32", "--height", "24",
               "--samples", "8", "--samples-per-pass", "2", "--device",
               device, "--mesh", mesh_arg, "--checkpoint", out + ".ck.npz",
               "--checkpoint-every", "2", "--raw-output", out + ".raw",
               "--output", out + ".png"])
assert rc == 0, rc
# segments of one chunk (rounded to the spp axis), each followed by a
# time-based flush (PT_FLUSH_S=0), which the ranks agree on
os.environ.update(PT_COORDINATOR=f"127.0.0.1:{flush_port}", PT_FLUSH_S="0",
                  PT_SEG_SPP="2")
rc = cli.main(["--scene", "reference", "--width", "32", "--height", "24",
               "--samples", "8", "--samples-per-pass", "2", "--device",
               device, "--mesh", mesh_arg, "--raw-output", out + ".flush.raw",
               "--output", out + ".flush.png"])
assert rc == 0, rc
# a failure on one rank rewinds both, and gives up on both
stop_args = ["--scene", "reference", "--width", "32", "--height", "24",
             "--samples", "8", "--samples-per-pass", "2", "--device", device,
             "--mesh", mesh_arg, "--checkpoint", out + ".stop.ck.npz",
             "--checkpoint-every", "2"]
del os.environ["PT_FLUSH_S"], os.environ["PT_SEG_SPP"]
os.environ.update(PT_COORDINATOR=f"127.0.0.1:{stop_port}")
if rank == "0":
    os.environ.update(PT_FAULT_INJECT="2", PT_FAULT_COUNT="9")
try:
    cli.main(stop_args + ["--raw-output", out + ".stop.raw",
                          "--output", out + ".stop.png"])
    stopped = "finished"
except Exception as e:  # noqa: BLE001 - recorded for the test
    stopped = f"{type(e).__name__}: {e}"
# rank 0 alone has a checkpoint; both resume from it, and a failure on
# rank 1 alone rewinds both
os.environ.update(PT_COORDINATOR=f"127.0.0.1:{resume_port}")
os.environ.pop("PT_FAULT_INJECT", None)
os.environ.pop("PT_FAULT_COUNT", None)
if rank == "1":
    os.environ.update(PT_FAULT_INJECT="3")
rc = cli.main(stop_args + ["--resume", "--raw-output", out + ".resume.raw",
                           "--output", out + ".resume.png",
                           "--metrics-json", out + ".resume.json"])
assert rc == 0, rc
np.savez(out, mega=mega, wave=wave, all_reduce=times["all_reduce"],
         all_gather=times["all_gather"], agree=agree, stopped=stopped)
print(f"rank {rank}: ok")
