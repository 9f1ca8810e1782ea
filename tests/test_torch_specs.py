"""The port's input specs and dummy inputs against the JAX package's.

``train_input_specs`` / ``decode_input_specs`` give meta tensors of the
reference's shapes and dtypes for every arch and shape; the dummy inputs,
drawn from numpy as the reference draws them, are equal bit for bit, the
bf16 patches and frames included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.launch import specs
from repro_torch.models.convert import to_numpy

pytestmark = pytest.mark.torch_port

#: The archs both packages register (nemotron-3-nano-30b-a3b is the
#: port's alone: ``test_torch_nemotron.py`` holds it to its plain reference).
BOTH = sorted(set(ARCHS) & set(J_ARCHS))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", BOTH)
def test_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in J_SHAPES:
        shape, jshape = get_shape(name), J_SHAPES[name]
        if shape.kind == "decode":
            port, ref = specs.decode_input_specs(cfg, shape), jspecs.decode_input_specs(jcfg, jshape)
        elif cfg.frontend == "patch" and cfg.frontend_len >= shape.seq_len:
            continue  # the reference asserts the patches fit the sequence
        else:
            port, ref = specs.train_input_specs(cfg, shape), jspecs.train_input_specs(jcfg, jshape)
        assert set(port) == set(ref)
        for k, t in port.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (name, k)
            assert _dtype_name(t.dtype) == jnp.dtype(ref[k].dtype).name, (name, k)


@pytest.mark.parametrize("arch", BOTH)
def test_dummy_inputs_are_bit_equal(arch):
    cfg = get_config(arch)
    s = cfg.frontend_len + 16 if cfg.frontend == "patch" else 32
    port = specs.dummy_train_inputs(cfg, 2, s, seed=3)
    ref = jspecs.dummy_train_inputs(j_get_config(arch), 2, s, seed=3)
    assert set(port) == set(ref)
    for k, t in port.items():
        r = np.asarray(ref[k])
        if r.dtype.name == "bfloat16":
            r = r.view(np.uint16)
        p = to_numpy(t)
        assert p.dtype == r.dtype and p.shape == r.shape and np.array_equal(p, r), k
