"""Linear and the recurrent node kinds in yolodl_torch's builder against
yolodl_tpu's GraphModel, on small darknet and NEWSLAB graphs with the same
seeded weights (``_torch_parity.seeded_trees`` of the reference's init,
carried across by the bridge): every node's output in eval mode; the
output, the new BN statistics and every parameter's gradient in train mode;
the NHWC flatten order of a Linear after a conv with ragged h, w and c;
``.weights`` files of [connected], [rnn], [gru], [lstm] and [crnn] written
by the port byte-identical to the reference's saver and read back; and
``zoo.load_darknet_classifier`` against the reference's, with and without
a ``.weights`` file.

Tolerance: node outputs rtol 1e-4 with atol 1e-4 · max|ref| (as
tests/test_torch_node_kinds.py); train-mode outputs and BN statistics
within 1e-5 of the largest reference entry and gradients within 1e-5 of the
largest reference gradient, as tests/test_torch_recurrent.py holds the ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat_leaves, seeded_trees
from yolodl_torch.bridge import _kernel_to_jax, params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.models import GraphModel, zoo
from yolodl_torch.models import weights as t_weights
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import weights as j_weights
from yolodl_tpu.models import zoo as j_zoo
from yolodl_tpu.models.builder import GraphModel as JGraphModel

torch.set_num_threads(2)

TOL = 1e-5

# a conv on a ragged 5 x 7 map with 5 channels, flattened by two [connected]
RAGGED = """[net]
width=7
height=5
channels=3

[convolutional]
batch_normalize=1
filters=5
size=3
stride=1
pad=1
activation=leaky

[connected]
output=9
batch_normalize=1
activation=leaky

[dropout]
probability=.5

[connected]
output=4
activation=linear

[softmax]

[cost]
type=sse
"""

# every dense and recurrent kind, 2 time steps: [rnn] reads a 4-D map, so
# its input-side weights are permuted in the .weights file as a
# [connected]'s are
SEQUENCE = """[net]
width=4
height=3
channels=3
time_steps=2

[convolutional]
batch_normalize=1
filters=4
size=3
stride=1
pad=1
activation=leaky

[crnn]
batch_normalize=1
size=3
pad=1
output=5
hidden=3
activation=leaky

[rnn]
batch_normalize=1
output=6
hidden=5
activation=leaky

[connected]
output=7
batch_normalize=1
activation=leaky

[gru]
batch_normalize=1
output=6

[lstm]
batch_normalize=1
output=5

[crnn]
size=1
pad=0
output=4
hidden=3
activation=leaky

[connected]
output=3
activation=linear

[softmax]
"""


def build(text, seed=0):
    """(reference model, params, state, port model) with the same seeded
    weights and BN statistics away from init."""
    jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)), spd_stem="off")
    params, state = seeded_trees(jm.init, seed)
    tm = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
    params_from_jax(params, state, model=tm)
    return jm, params, state, tm


def nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def assert_nodes_match(jm, params, state, tm, x):
    """Every tensor node, eval mode: port = reference (NCHW)."""
    _, _, named = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, train=False,
                                                    return_intermediates=True))(params, state, x)
    keys = tuple(k for k in tm.graph.order if tm.graph.nodes[k].output_shape.is_tensor)
    with torch.no_grad():
        outs = tm(torch.from_numpy(x), output_keys=keys)
    for key in keys:
        name = tm._pname[key]
        r, o = nchw(named[name]), outs[key].numpy()
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=name)
    return outs


def assert_train_matches(jm, params, state, tm, x, seed=3):
    """Train mode: the output, the new BN statistics (the port writes them
    into its buffers) and the gradient of a seeded weighted sum of the
    output (NCHW), by ``jax.grad`` and by autograd."""
    def j_out_nchw(p):
        out, new_state = jm.apply(p, state, jnp.asarray(x), train=True)
        return (jnp.transpose(out, (0, 3, 1, 2)) if out.ndim == 4 else out), new_state

    out_shape = jax.eval_shape(lambda p: j_out_nchw(p)[0], params).shape
    r = np.random.default_rng(seed).normal(size=out_shape).astype(np.float32)

    def j_loss(p):
        out, new_state = j_out_nchw(p)
        return jnp.sum(out * r), (out, new_state)

    (_, (j_out, j_state)), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(r)).sum().backward()
    ref = np.asarray(j_out)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg="train output")
    j_flat, t_flat = flat_leaves(j_state), flat_leaves(params_to_jax(tm.state_dict())[1])
    assert set(t_flat) == set(j_flat) and j_flat
    for k, v in j_flat.items():
        np.testing.assert_allclose(t_flat[k], v, rtol=0, atol=TOL * np.abs(v).max(),
                                   err_msg=f"state {k}")
    t_vars = tm.state_dict(keep_vars=True)
    j_g = flat_leaves(j_grad)
    g_max = max(float(np.abs(g).max()) for g in j_g.values())
    for k, g in j_g.items():
        got = t_vars["layers." + k.replace("/", ".")].grad.numpy()
        if k.endswith("/w"):
            got = _kernel_to_jax(got)
        np.testing.assert_allclose(got, g, rtol=0, atol=TOL * g_max, err_msg=f"gradient {k}")


def test_linear_after_ragged_conv_flattens_nhwc():
    jm, params, state, tm = build(RAGGED, 1)
    x = np.random.default_rng(2).uniform(0, 1, (4, 3, 5, 7)).astype(np.float32)
    outs = assert_nodes_match(jm, params, state, tm, x)
    assert tuple(outs[tm.graph.order[-1]].shape) == (4, 4)
    assert tuple(tm.layers["layer1"].w.shape) == (9, 5 * 7 * 5)
    assert_train_matches(jm, params, state, tm, x)


def test_every_dense_and_recurrent_kind_matches():
    jm, params, state, tm = build(SEQUENCE, 4)
    kinds = {n.config.kind for n in tm.graph.nodes.values()}
    assert {"Linear", "DarknetRnn", "DarknetGru", "DarknetLstm", "DarknetCrnn"} <= kinds
    x = np.random.default_rng(5).uniform(0, 1, (2 * 4, 3, 3, 4)).astype(np.float32)
    outs = assert_nodes_match(jm, params, state, tm, x)
    assert tuple(outs[tm.graph.order[-1]].shape) == (8, 3)
    assert_train_matches(jm, params, state, tm, x)


def test_weights_round_trip_is_byte_identical(tmp_path):
    """The reference's saver and the port's, on the same trees, write the
    same bytes; the port reads them back into its model unchanged, and so
    does the reference."""
    jm, params, state, tm = build(SEQUENCE, 6)
    cfg = tmp_path / "seq.cfg"
    cfg.write_text(SEQUENCE)
    ref_file, port_file = tmp_path / "ref.weights", tmp_path / "port.weights"
    j_weights.save_darknet_weights(j_dk.Darknet.from_str(SEQUENCE), params, state, ref_file)
    t_weights.save_darknet_weights(t_dk.Darknet.from_str(SEQUENCE),
                                   *params_to_jax(tm.state_dict()), port_file)
    assert port_file.read_bytes() == ref_file.read_bytes()
    loaded = zoo.load_darknet_classifier(str(cfg), str(port_file), seed=9, device="cpu")
    want = tm.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    j_p, j_s, _ = j_weights.load_darknet_weights(j_dk.Darknet.from_str(SEQUENCE), port_file)
    for k, v in flat_leaves(params).items():
        np.testing.assert_array_equal(flat_leaves(j_p)[k], v)
    for k, v in flat_leaves(state).items():
        np.testing.assert_array_equal(flat_leaves(j_s)[k], v)


def test_load_darknet_classifier_matches_reference(tmp_path):
    """Without a file: the same structure (parameter names and shapes, the
    bridge's mapping of the reference's init), the port's own seeded init,
    the card by default.  With one: the same weights and the same forward."""
    cfg = tmp_path / "ragged.cfg"
    cfg.write_text(RAGGED)
    j_model, j_params, j_state = j_zoo.load_darknet_classifier(str(cfg))
    model = zoo.load_darknet_classifier(str(cfg), device="cpu")
    assert type(model) is GraphModel
    want = params_from_jax(j_params, j_state)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    again = zoo.load_darknet_classifier(str(cfg), device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in got.items())

    _, params, state, tm = build(RAGGED, 7)
    weights = tmp_path / "ragged.weights"
    j_weights.save_darknet_weights(j_dk.Darknet.from_str(RAGGED), params, state, weights)
    j_model, j_params, j_state = j_zoo.load_darknet_classifier(str(cfg), str(weights))
    model = zoo.load_darknet_classifier(str(cfg), str(weights), device="cpu")
    for k, v in params_from_jax(j_params, j_state).items():
        assert torch.equal(model.state_dict()[k], v), k
    x = np.random.default_rng(8).uniform(0, 1, (2, 3, 5, 7)).astype(np.float32)
    ref, _ = j_model.apply(j_params, j_state, x, train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_load_darknet_classifier_needs_a_card_by_default(tmp_path, monkeypatch):
    cfg = tmp_path / "ragged.cfg"
    cfg.write_text(RAGGED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.load_darknet_classifier(str(cfg))


@pytest.mark.parametrize("bn,act", [(False, "linear"), (True, "leaky")])
def test_newslab_linear(bn, act):
    """The NEWSLAB Linear kind (``bn: {enabled: true}`` opts into darknet's
    scale-only BN) after a conv on an 8² map."""
    spec = {
        "main_group": "m",
        "groups": {"m": [
            {"name": "input", "kind": "Input", "shape": ["_", 3, 8, 6]},
            {"kind": "ConvBn2D", "c": 5, "k": 3, "s": 2},
            {"name": "output", "kind": "Linear", "out": 7, "act": act,
             "bn": {"enabled": bn}},
        ]},
    }
    jm = JGraphModel(JGraph.from_model(j_cfg.parse_model_dict(spec)), spd_stem="off")
    params, state = seeded_trees(jm.init, 10)
    tm = GraphModel(TGraph.from_model(t_cfg.parse_model_dict(spec)), device="cpu")
    params_from_jax(params, state, model=tm)
    assert ("bn" in params["output"]) == bn
    x = np.random.default_rng(11).uniform(0, 1, (8, 3, 8, 6)).astype(np.float32)
    assert_nodes_match(jm, params, state, tm, x)
    assert_train_matches(jm, params, state, tm, x)
