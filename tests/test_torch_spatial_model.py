"""``yolodl_torch.parallel.spatial_model``'s planner against
``yolodl_tpu.parallel.spatial_model``'s: the sharded node set and the cut
list, key for key, on the graphs' static shapes (no ranks run).

yolov4-tiny and yolov4-csp at 64², 256², 608² and 1216² (the cfg with its
``width``/``height`` set), and the 6 NEWSLAB models of ``cfg/model`` at
their own sizes, each over 2, 4 and 8 shards.  Then the admission cases
of the reference's tests/test_spatial_model.py:204-258 and its check that
the high-resolution stages are in the prefix; the meshes' size errors (a
one-rank group in this process) and the refusals of a model with no
shardable prefix and of a darknet-loss config.  The spatial inference is
in test_torch_spatial_infer.py, the train step in
test_torch_spatial_step.py and test_torch_spatial_f64.py.
"""

import glob
import os
import re
import types

import pytest

from _torch_parity import REPO
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.parallel.spatial_model import _conv_shardable as j_conv_shardable
from yolodl_tpu.parallel.spatial_model import _pool_shardable as j_pool_shardable
from yolodl_tpu.parallel.spatial_model import plan_spatial_prefix as j_plan
from yolodl_torch.config import newslab as cfg
from yolodl_torch.graph import Graph
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.parallel.spatial_model import (_conv_shardable, _pool_shardable,
                                                 plan_spatial_prefix)

SIZES = (64, 256, 608, 1216)
SHARDS = (2, 4, 8)
NEWSLAB = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "cfg", "model",
                                                                      "*.json5")))


def sized_cfg(tmp_path, name, size):
    text = open(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg")).read()
    text = re.sub(r"(?m)^width=\d+", f"width={size}", text)
    text = re.sub(r"(?m)^height=\d+", f"height={size}", text)
    path = tmp_path / f"{name}-{size}.cfg"
    path.write_text(text)
    return str(path)


def both_plans(j_graph, t_graph, n):
    ref = j_plan(types.SimpleNamespace(graph=j_graph), n)
    got = plan_spatial_prefix(types.SimpleNamespace(graph=t_graph), n)
    return ref, got


@pytest.mark.parametrize("name", ["yolov4-tiny", "yolov4-csp"])
@pytest.mark.parametrize("size", SIZES)
def test_plan_equals_the_reference_on_darknet_cfgs(tmp_path, name, size):
    path = sized_cfg(tmp_path, name, size)
    j_graph, t_graph = j_load(path), load_darknet_graph(path)
    for n in SHARDS:
        (j_sharded, j_cut), (sharded, cut) = both_plans(j_graph, t_graph, n)
        assert sharded == j_sharded, (n, sorted(sharded ^ j_sharded))
        assert cut == j_cut, n


def test_plan_of_the_flagship_cuts_where_the_heights_stop_dividing(tmp_path):
    """yolov4-csp: at 608² the prefix stops at /16 (19 rows do not halve);
    at 1216² over 2 it reaches /32 (38 rows)."""
    graph = load_darknet_graph(sized_cfg(tmp_path, "yolov4-csp", 608))
    model = types.SimpleNamespace(graph=graph)
    heights = {k: graph.nodes[k].output_shape.tensor_shape()[2].size for k in graph.order
               if graph.nodes[k].output_shape.is_tensor}
    sharded, cut = plan_spatial_prefix(model, 2)
    assert len(sharded) == 85 and len(graph.order) == 177
    assert {heights[k] for k in cut} == {76, 38}
    big = load_darknet_graph(sized_cfg(tmp_path, "yolov4-csp", 1216))
    sharded, cut = plan_spatial_prefix(types.SimpleNamespace(graph=big), 2)
    assert len(sharded) == 173


@pytest.mark.parametrize("name", NEWSLAB)
def test_plan_equals_the_reference_on_newslab_models(name):
    path = os.path.join(REPO, "cfg", "model", name)
    j_graph, t_graph = JGraph.load_newslab_v1_json(path), Graph.load_newslab_v1_json(path)
    for n in SHARDS:
        (j_sharded, j_cut), (sharded, cut) = both_plans(j_graph, t_graph, n)
        assert sharded == j_sharded, (n, sorted(sharded ^ j_sharded))
        assert cut == j_cut, n


@pytest.mark.parametrize("fields,shardable", [
    (dict(k=3, s=1, p=0), False),   # "valid" k3: each shard would lose k−1 rows
    (dict(k=1, s=1, p=0), True),    # pad 0, k1: aligned, exact
    (dict(k=3, s=1, p=1), True),    # same-pad k3: halo, exact
])
def test_conv_admission(fields, shardable):
    """tests/test_spatial_model.py:208-220, and the reference's predicate
    agrees."""
    assert _conv_shardable(cfg.ConvBn2D(name="c", c=8, **fields), 64, 4) is shardable
    assert j_conv_shardable(j_cfg.ConvBn2D(name="c", c=8, **fields), 64, 4) is shardable


@pytest.mark.parametrize("fields,shardable", [
    # an avg pool in an SPP branch would need count-aware halos (:222-231)
    (dict(size=5, stride_y=1, stride_x=1, total_padding=4, pool_kind="avg"), False),
    (dict(size=5, stride_y=1, stride_x=1, total_padding=4, pool_kind="max"), True),
    # torch-style symmetric padding would pad every shard's edges (:233-244)
    (dict(size=2, stride_y=2, stride_x=2, padding=1, total_padding=None), False),
    (dict(size=2, stride_y=2, stride_x=2, padding=0, total_padding=None), True),
])
def test_pool_admission(fields, shardable):
    assert _pool_shardable(cfg.MaxPool(name="p", **fields), 64, 4) is shardable
    assert j_pool_shardable(j_cfg.MaxPool(name="p", **fields), 64, 4) is shardable


def test_planner_covers_high_res_stages(tmp_path):
    """tests/test_spatial_model.py:247-258: over 90 % of yolov4-csp's nodes
    at 64 rows or more are in the prefix at 256² over 4 shards."""
    graph = load_darknet_graph(sized_cfg(tmp_path, "yolov4-csp", 256))
    sharded, _ = plan_spatial_prefix(types.SimpleNamespace(graph=graph), 4)
    hi_res = [k for k in graph.order
              if graph.nodes[k].output_shape.is_tensor
              and graph.nodes[k].output_shape.tensor_shape()[2].is_known
              and graph.nodes[k].output_shape.tensor_shape()[2].size >= 64]
    covered = sum(1 for k in hi_res if k in sharded)
    assert covered / len(hi_res) > 0.9, (covered, len(hi_res))


def test_meshes_of_the_wrong_size_name_the_mesh_and_the_count():
    """A group of one rank (this process) cannot be a 2 × 2 data × space
    mesh, nor a space mesh of 2; a 1 × 1 mesh prints its route."""
    from yolodl_torch.parallel.mesh import (destroy_process_group, free_port,
                                            init_process_group, make_data_space_mesh,
                                            make_space_mesh)

    init_process_group("cpu", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                       world_size=1)
    try:
        with pytest.raises(ValueError, match=r"data x space mesh 2x2 needs 4 devices, have 1"):
            make_data_space_mesh(2, 2)
        with pytest.raises(ValueError, match=r"space mesh of 2 needs 2 devices, have 1"):
            make_space_mesh(2)
        mesh = make_space_mesh(1)
        assert (mesh.n_data, mesh.n_space, mesh.data_index, mesh.space_index) == (1, 1, 0, 0)
        assert mesh.route == "gloo, staged through host memory"
    finally:
        destroy_process_group()


def test_no_shardable_prefix_and_the_darknet_loss_are_refused(tmp_path):
    """The reference's ValueErrors (spatial_model.py:271-273, :356-358):
    an input height that does not divide over the shards leaves no prefix;
    the step runs yolo_loss only, so a darknet-loss config is refused."""
    from yolodl_torch.models import YoloModel
    from yolodl_torch.parallel.spatial_model import make_spatial_infer, make_spatial_train_step
    from yolodl_torch.train import loop

    model = YoloModel(load_darknet_graph(sized_cfg(tmp_path, "yolov4-tiny", 96)), device="cpu")
    mesh = types.SimpleNamespace(n_data=1, n_space=5)
    with pytest.raises(ValueError, match="no shardable prefix"):
        make_spatial_infer(model, mesh)
    ts, opt = loop.train_init(model, loop.TrainConfig())
    with pytest.raises(ValueError, match="no shardable prefix"):
        make_spatial_train_step(model, opt, loop.TrainConfig(), mesh)
    dk = loop.TrainConfig(darknet_loss=((), ()))
    with pytest.raises(ValueError, match="runs yolo_loss"):
        make_spatial_train_step(model, opt, dk, types.SimpleNamespace(n_data=1, n_space=2))
