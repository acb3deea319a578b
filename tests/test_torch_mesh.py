"""The port's meshes and sharding rules (``ray_tpu_torch.parallel.mesh``,
``.sharding``, ``state_shardings``) against the JAX package's
(``ray_tpu.parallel``) on the 8-device CPU mesh: the axis order, the
``-1`` wildcard, the error texts up to the device listing (JAX lists its
CPU devices by name, the port by ``torch.device``), and the spec trees
leaf for leaf, dense and MoE. Specs are compared as tuples, the port's
``PartitionSpec`` being one.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu import parallel as J  # noqa: E402
from ray_tpu.models.llama import LlamaConfig as JConfig  # noqa: E402
from ray_tpu_torch import parallel as T  # noqa: E402
from ray_tpu_torch.models.llama import LlamaConfig as TConfig  # noqa: E402

CPU8 = ["cpu"] * 8
MESHES = [{"data": -1}, {"data": 2, "fsdp": 4}, {"fsdp": -1, "tensor": 2},
          {"tensor": 2, "data": 4}, {"seq": 4, "data": -1},
          {"expert": 4, "data": 2}, {"pipe": 4, "data": 2},
          {"expert": 2, "tensor": 2, "fsdp": 2}, {"data": 8}]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("axes", MESHES)
def test_make_mesh_order_and_wildcard(axes):
    jm = J.make_mesh(axes)
    tm = T.make_mesh(axes, devices=CPU8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape
    assert tm.size == 8 and tm.device == torch.device("cpu")
    for name in ("data", "fsdp", "tensor", "nope"):
        assert T.mesh_axis_size(tm, name) == J.mesh_axis_size(jm, name)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("axes", [{"data": 3}, {"data": -1, "fsdp": 3},
                                  {"data": -1, "fsdp": -1},
                                  {"data": 2, "tensor": 2}])
def test_make_mesh_errors_keep_the_reference_text(axes):
    want = _message(lambda: J.make_mesh(axes))
    got = _message(lambda: T.make_mesh(axes, devices=CPU8))
    # The same words up to the listing of the devices found.
    cut = lambda s: s.split(": [")[0]  # noqa: E731
    assert cut(got) == cut(want)
    if "discovered" in want:
        assert "discovered 8 device(s) on platform cpu (chip cpu, spec " \
            in got
        assert got.endswith("; process 0 of 1")


def test_make_mesh_without_devices_takes_the_cards():
    """With no ``devices=`` the inventory is torch.cuda's: on a host
    without a card a mesh cannot be filled, and the text says so; the
    port never counts the CPU in on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    assert T.discover_devices() == []
    msg = _message(lambda: T.make_mesh({"data": 1}))
    assert re.search(r"needs devices but 0 are available; discovered 0 "
                     r"device\(s\) on platform none", msg), msg
    with pytest.raises(ValueError, match="0 are available"):
        T.data_parallel_mesh()


def test_device_inventory():
    inv = T.device_inventory(CPU8)
    assert inv["devices"] == 8 and inv["platforms"] == ["cpu"]
    assert inv["device_kinds"] == ["cpu"] and inv["spec"] == "cpu"
    assert T.device_inventory([])["devices"] == 0


def test_a_mesh_over_two_devices_in_one_process_is_refused():
    mesh = T.make_mesh({"data": 2}, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="mesh across processes"):
        mesh.device
    assert repr(mesh) == "Mesh({'data': 2}, on cpu, meta)"


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("experts", [0, 4])
def test_llama_param_specs_match_reference(axes, experts):
    kw = dict(n_experts=experts, n_kv_heads=4) if experts else {}
    jc, tc = JConfig.tiny(**kw), TConfig.tiny(**kw)
    jm, tm = J.make_mesh(axes), T.make_mesh(axes, devices=CPU8)
    want = _tuples(J.llama_param_specs(jc, jm))
    assert _tuples(T.llama_param_specs(tc, tm)) == want
    shardings = T.llama_param_shardings(tc, tm)
    assert shardings["layers"]["wq"].spec == want["layers"]["wq"]
    assert shardings["layers"]["wq"].mesh is tm
    assert tuple(T.batch_spec(tm)) == tuple(J.batch_spec(jm))


def test_tied_embeddings_drop_the_head_spec():
    tm = T.make_mesh({"fsdp": 8}, devices=CPU8)
    assert "lm_head" not in T.llama_param_specs(
        TConfig.tiny(tie_embeddings=True), tm)


@pytest.mark.parametrize("axes,config,match", [
    ({"tensor": 8}, dict(n_kv_heads=4),
     r"tensor axis \(8\) must divide n_kv_heads \(4\)"),
    ({"expert": 8}, dict(n_experts=4),
     r"expert axis \(8\) must divide n_experts \(4\)")])
def test_divisibility_errors_match_reference(axes, config, match):
    with pytest.raises(ValueError, match=match):
        J.llama_param_specs(JConfig.tiny(**config), J.make_mesh(axes))
    with pytest.raises(ValueError, match=match):
        T.llama_param_specs(TConfig.tiny(**config),
                            T.make_mesh(axes, devices=CPU8))


def test_partition_spec_is_a_tuple():
    spec = T.PartitionSpec(None, ("data", "fsdp"), "tensor")
    assert spec == (None, ("data", "fsdp"), "tensor")
    assert len(T.PartitionSpec()) == 0
    assert repr(spec).startswith("PartitionSpec(")
    import pickle

    assert pickle.loads(pickle.dumps(spec)) == spec


def test_shard_params_places_and_records():
    from ray_tpu_torch.models.llama import init_params

    tc = TConfig.tiny()
    tm = T.make_mesh({"fsdp": 4, "tensor": 2}, devices=CPU8)
    params = init_params(tc, 0, "cpu")
    sharded = T.shard_params(params, T.llama_param_shardings(tc, tm))
    wq = sharded["layers"]["wq"]
    assert torch.equal(wq, params["layers"]["wq"])
    assert wq.sharding.spec == (None, "fsdp", "tensor")
    state = T.create_train_state(sharded, device="cpu")
    assert state.params["layers"]["wq"].sharding.spec == wq.sharding.spec
    assert T.replicated(tm).spec == ()
    assert T.batch_sharding(tm).spec == ("fsdp",)
    assert T.batch_spec(T.make_mesh({"data": 2, "fsdp": 4},
                                    devices=CPU8)) == (("data", "fsdp"),)


@pytest.mark.parametrize("axes,weight_update", [
    ({"data": 4, "fsdp": 2}, "replicated"), ({"data": 4, "fsdp": 2},
                                             "sharded"),
    ({"fsdp": 4, "tensor": 2}, "replicated"), ({"data": 8}, "replicated"),
    ({"data": 8}, "sharded"), ({"data": 2, "tensor": 4}, "sharded")])
def test_state_shardings_match_reference(axes, weight_update):
    """The moments mirror their params' specs, with ``data`` folded into
    dim 0 under the sharded update (the reference's
    ``zero_moment_shardings``); AdamW's moments are optax's mu and nu."""
    jc = JConfig.tiny(n_kv_heads=4)
    tc = TConfig.tiny(n_kv_heads=4)
    jm, tm = J.make_mesh(axes), T.make_mesh(axes, devices=CPU8)
    from ray_tpu.models.llama import init_params as j_init

    jshape = jax.eval_shape(lambda: j_init(jc, jax.random.key(0)))
    jsh = J.state_shardings(J.llama_param_shardings(jc, jm),
                            optax.adamw(1e-3), jshape, jm, weight_update)
    mu = _tuples(jax.tree.map(lambda s: s.spec, jsh.opt_state[0].mu))
    tshape = jax.tree.map(lambda s: tuple(s.shape), jshape)
    tsh = T.state_shardings(T.llama_param_shardings(tc, tm), None, tshape,
                            tm, weight_update)
    assert sorted(tsh["opt_state"]) == ["exp_avg", "exp_avg_sq", "step"]
    for name in ("exp_avg", "exp_avg_sq"):
        assert _spec_tuples(tsh["opt_state"][name]) == mu
    assert tsh["step"].spec == () and tsh["opt_state"]["step"].spec == ()


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree.spec)


def test_zero_moment_shardings_is_the_sharded_opt_state():
    tm = T.make_mesh({"data": 8}, devices=CPU8)
    from ray_tpu_torch.parallel.zero import zero_moment_shardings

    shape = {"a": (16, 3), "b": (5,)}
    specs = {"a": T.PartitionSpec(None, None), "b": T.PartitionSpec(None)}
    out = zero_moment_shardings(specs, None, shape, tm)
    assert out["exp_avg"]["a"].spec == ("data", None)
    assert out["exp_avg"]["b"].spec == (None,)       # 5 % 8: kept
