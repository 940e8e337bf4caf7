"""How far the JAX package's own train-step gradients move when only
remat changes, beside the port's gap to them: the yardstick behind the
hybrid's step bound in ``tests/test_torch_hybrid_train.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_remat_spread.py \\
        jamba-1.5-large-398b-smoke

compiles ``repro.launch.steps.make_train_step`` at the published
training numerics (bf16 masters, ``adam_int8``, 2 micro-batches, the
search) with remat on and off (about 90 s each on the CPU), runs the
port's step beside them, and prints the relative L2 gap of each
gradient leaf: JAX with remat against JAX without, and the port against
each.  Remat changes no value of the math, only what XLA compiles.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_train_cases as tc
from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.optim import optimizers as jopt
from repro_torch.bridge import lm_params_from_jax, tree_to_numpy
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt


def main(arch: str) -> None:
    torch.set_num_threads(1)
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    tree = tree_to_numpy(tlm.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu", mps_on=True))
    stree = tree_to_numpy(tc._cast_tree(lm_params_from_jax(tree, cfg=tcfg)))
    jb, tb_ = tc.batch(jcfg, 1, 4, 33)
    grads = {}
    for remat in (True, False):
        kw = dict(tc.STEP_NUMERICS, remat=remat)
        jo = tc._capturing(jopt.Optimizer,
                           jopt.make_optimizer("adam_int8", tc.LR))
        jsp = jax.tree.map(jnp.asarray, stree)
        step = jax.jit(jsteps.make_train_step(
            dataclasses.replace(jcfg, **kw), jo, search=True))
        _, st, _ = step(jsp, jo.init(jsp), jb, jnp.asarray(0))
        grads[f"jax remat {remat}"] = tc.flat(st["grads"])
        to = tc._capturing(topt.Optimizer,
                           topt.make_optimizer("adam_int8", tc.LR))
        tcs = dataclasses.replace(tcfg, **kw)
        tsp = lm_params_from_jax(stree, cfg=tcs)
        _, st, _ = tsteps.make_train_step(tcs, to, search=True)(
            tsp, to.init(tsp), tb_, 0)
        grads[f"port remat {remat}"] = tc.flat(st["grads"])
    for a, b in (("jax remat True", "jax remat False"),
                 ("port remat True", "jax remat True"),
                 ("port remat False", "jax remat False")):
        gaps = {k: tc.rel(grads[a][k], v) for k, v in grads[b].items()}
        worst = max(gaps, key=gaps.get)
        print(f"{a} vs {b}: largest {worst} {gaps[worst]:.4g}, median "
              f"{np.median(list(gaps.values())):.4g}")


if __name__ == "__main__":
    main(sys.argv[1])
