"""Four SGD steps of the toy fusion model through the port's engine and
loader and through the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgnns_tpu.config import ModelConfig as JModelConfig
from mgnns_tpu.data.loader import DeviceLoader as JDeviceLoader
from mgnns_tpu.engine.train import Engine as JEngine
from mgnns_tpu.graphs.cooccur import gen_A
from mgnns_tpu.models import mgnns_apply as j_mgnns_apply
from mgnns_tpu.models.mgnns import mgnns_init as j_mgnns_init

from mgnns_tpu_torch import convert
from mgnns_tpu_torch.config import ModelConfig
from mgnns_tpu_torch.data.loader import DeviceLoader
from mgnns_tpu_torch.engine.train import Engine
from mgnns_tpu_torch.models.mgnns import mgnns_apply
from tests.torch_train_common import CPU, datasets, make_data, np_tree, step_losses


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(str(tmp_path_factory.mktemp("data")))


def test_engine_sgd_trajectory_matches_jax_fusion(data):
    """Four SGD steps of the toy fusion model (image 32, 5/6 label classes,
    dropout 0) through both engines and loaders: losses within 1e-4
    relative.  The trunks are frozen: through randomly initialized trunks
    float32 rounding alone moves the trunk gradients by percents, in either
    BatchNorm mode, and SGD carries that into the next steps' losses
    (tests/test_torch_train.py holds the trunk gradients and train-mode
    BatchNorm).  At ten times this learning rate the text GCN's max
    aggregations switch winners between the packages by the fourth step."""
    jds, ds = datasets(data)
    r = np.random.default_rng(0)
    obj_c, plc_c = 5, 6
    kw = dict(vocab_size=len(data["vocab"]), edges_num=data["graph"].num_edges, image_size=32,
              object_num_classes=obj_c, place_num_classes=plc_c, dropout=0.0, text_dropout=0.0,
              freeze_trunks=True)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    oA, _ = gen_A(obj_c, 0.4, {"nums": r.integers(1, 5, obj_c).astype(float),
                               "adj": r.integers(0, 4, (obj_c, obj_c)).astype(float)})
    pA, _ = gen_A(plc_c, 0.3, {"nums": r.integers(1, 5, plc_c).astype(float),
                               "adj": r.integers(0, 4, (plc_c, plc_c)).astype(float)})
    jparams, jstate, jconsts = j_mgnns_init(
        jax.random.key(0), jcfg, num_edges=data["graph"].num_edges,
        label_embedding=r.standard_normal((7, 300)).astype(np.float32), object_A=oA, place_A=pA)
    object_inp = r.standard_normal((obj_c, 300)).astype(np.float32)
    place_inp = r.standard_normal((plc_c, 300)).astype(np.float32)
    params, stats, consts = convert.from_jax_params(
        np_tree(jparams), np_tree(jstate), dict(np_tree(jconsts), object_inp=object_inp, place_inp=place_inp),
        device=CPU)

    def japply(p, bs, batch, *, train, rng):
        full = dict(batch, object_inp=jnp.asarray(object_inp), place_inp=jnp.asarray(place_inp))
        return j_mgnns_apply(p, bs, jconsts, full, cfg=jcfg, train=train, rng=rng)[:2]

    def papply(p, bs, batch, *, train, generator):
        return mgnns_apply(p, bs, consts, batch, cfg=cfg, train=train, generator=generator)[:2]

    ekw = dict(num_classes=7, lr=3e-3, optimizer_algo="sgd", steps_per_epoch=3, seed=0,
               freeze_trunks=True)
    jeng = JEngine(japply, jparams, jstate, **ekw)
    eng = Engine(papply, params, stats, device=CPU, **ekw)
    jl = JDeviceLoader(jds, 3, shuffle=True, seed=0, num_threads=2)
    pl = DeviceLoader(ds, 3, shuffle=True, seed=0, num_threads=2, device=CPU)
    got, want = step_losses(jeng, eng, jl, pl, 4)
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
