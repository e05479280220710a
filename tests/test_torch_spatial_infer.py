"""``yolodl_torch.parallel.spatial_model.make_spatial_infer`` against the
reference's ``make_spatial_infer`` (under ``shard_map`` on the virtual CPU
devices of tests/conftest.py) and against the port's unsharded eval
forward, at the reference test's atol 2e-5
(tests/test_spatial_model.py:72-77).

Models: tests/test_pipeline.py's yolov4-tiny at 64² with 3 classes
(``pp_tiny``), and yolov4-csp at 64² with 3 classes and every conv's
filters cut to an eighth (``narrow_csp`` of test_torch_pp_csp.py: the
flagship's topology, SPP max pools and CSP routes included), each with the
seeded weights of ``seeded_trees`` carried across by the bridge.  Each runs
on 2 and on 4 ranks joined over gloo (``SPATIAL_RANK_SCRIPT``), on a batch
of 2 seeded images; every rank must return the same detections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pp_tiny, seeded_trees, start_spatial_ranks, wait_ranks
from test_torch_pp_csp import narrow_csp
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.parallel.spatial_model import make_spatial_infer as j_infer
from yolodl_tpu.parallel.spatial_model import plan_spatial_prefix as j_plan
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel

torch.set_num_threads(2)

FIELDS = ("cycxhw", "obj_logit", "class_logit")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    from jax.sharding import Mesh

    tmp = tmp_path_factory.mktemp("spatial_infer")
    path, jm, params, state, tm, init = pp_tiny(tmp, 64)
    csp_path = narrow_csp(tmp / "csp64.cfg")
    cm = JYoloModel(j_load(csp_path), spd_stem="off")
    c_params, c_state = seeded_trees(cm.init, 0)
    ctm = YoloModel(load_darknet_graph(csp_path), device="cpu")
    params_from_jax(c_params, c_state, model=ctm)
    c_init = {k: v.clone() for k, v in ctm.state_dict().items()}
    images = np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    cases = {"tiny": {"mode": "infer", "model": path, "init": init},
             "csp": {"mode": "infer", "model": csp_path, "init": c_init}}
    procs, outs = {}, {}
    for n in (2, 4):
        (tmp / str(n)).mkdir()
        procs[n], outs[n] = start_spatial_ranks(tmp / str(n), cases, {"images0": images}, n)
    refs, plans = {}, {}
    for name, model, p, s in (("tiny", jm, params, state), ("csp", cm, c_params, c_state)):
        p, s = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p, s))
        for n in (2, 4):
            mesh = Mesh(np.asarray(jax.devices()[:n]), ("space",))
            refs[(name, n)] = j_infer(model, mesh)(p, s, jnp.asarray(images))
            plans[(name, n)] = j_plan(model, n)
    unsharded = {}
    for name, model in (("tiny", tm), ("csp", ctm)):
        with torch.no_grad():
            unsharded[name] = model(torch.from_numpy(images))
    ranks = {}
    for n in (2, 4):
        wait_ranks(procs[n])
        ranks[n] = [dict(np.load(f"{outs[n]}.r{r}.npz")) for r in range(n)]
    return refs, plans, unsharded, ranks


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["tiny", "csp"])
def test_spatial_infer_matches_reference_and_unsharded(runs, name, n):
    refs, plans, unsharded, ranks = runs
    sharded, cut = plans[(name, n)]
    assert len(sharded) > 5 and cut  # the planner found a prefix
    for f in FIELDS:
        want = getattr(unsharded[name], f).numpy()
        ref = np.asarray(getattr(refs[(name, n)], f))
        assert np.abs(want).max() > 0.05, f
        for r, rank in enumerate(ranks[n]):
            got = rank[f"{name}/{r}/{f}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=f"rank {r} {f}")
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5, err_msg=f"rank {r} {f}")
            np.testing.assert_array_equal(got, ranks[n][0][f"{name}/0/{f}"])
