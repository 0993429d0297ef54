"""Nothing a cell's run loads is JAX, its libraries or the JAX package,
and the reference loads nothing of the program. Each check runs in a
fresh interpreter and compares top-level module names whole
(`stitchax_torch` is the program under test, not `stitchax`)."""

import json
import os
import subprocess
import sys

from portbench.tests.small import ROOT

BANNED = {"jax", "jaxlib", "flax", "optax", "stitchax"}


def _modules(code: str):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


REHEARSAL = """
import json, sys
from portbench.tests.small import run_small
from portbench.harness import result_line
for cell in ("eval.ffpp_udis2.b12", "train.ffpp_udis2.b8"):
    ctx, out = run_small(cell)
    result_line(ctx, out)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys, torch
from portbench.tests.small import overrides, ROOT
from portbench.reference.align import AlignConfig, align_train_forward
from portbench.reference.evaluate import eval_outputs, pair_scores
from portbench.reference.nets import build_nets, trained_params
from portbench.reference.train import AdamW, loss_and_grads
from portbench.traffic import make_pairs
torch.set_num_threads(2)
o = overrides("train.ffpp_udis2.b8")
cfg, tr = o["config"], o["traffic"]
a, b = make_pairs(tr, 1, 2, "cpu")
nets = build_nets(cfg, ROOT, upsample_all=True)
params = trained_params(nets)
loss, grads = loss_and_grads(nets, params, a, b, AlignConfig(), cfg["loss"],
                             True, 1)
AdamW(cfg["optim"], 2).step(params, grads)
w, v = eval_outputs(build_nets(cfg, ROOT), a, b, AlignConfig(), 1)
pair_scores(a.numpy(), w, v)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_rehearsal_of_each_cell_loads_no_jax():
    mods = _modules(REHEARSAL)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & BANNED, tops & BANNED
    assert "stitchax_torch" in tops          # the program did run


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (BANNED | {"stitchax_torch"}), tops & (
        BANNED | {"stitchax_torch"})
