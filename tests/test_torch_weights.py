"""Darknet .weights import and export of the PyTorch port.

The port's `save_darknet_weights` writes the same bytes as the JAX
package's on the same seeded `numpy_variables` tree; `load_darknet_weights`
reads them back bit for bit (and puts each value where the JAX loader does,
kernels in OIHW rather than HWIO); truncated and oversized files raise;
`expected_weight_count` equals the JAX count.
"""

import numpy as np
import pytest
import torch

from yolov3_tensorflow_tpu.utils import weights as jweights
from yolov3_tensorflow_tpu_torch.models.convert import from_jax_variables
from yolov3_tensorflow_tpu_torch.models.yolov3 import (darknet_layer_order,
                                                       init_yolov3)
from yolov3_tensorflow_tpu_torch.testing import (CPU_TEST_THREADS,
                                                 numpy_variables)
from yolov3_tensorflow_tpu_torch.utils import weights as tweights

torch.set_num_threads(CPU_TEST_THREADS)

CPU = torch.device("cpu")
C = 2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same tree written by both packages, and the trees."""
    d = tmp_path_factory.mktemp("weights")
    jvars = numpy_variables(C, seed=3)
    tvars = from_jax_variables(jvars, device=CPU)
    jweights.save_darknet_weights(jvars, str(d / "jax.weights"), C)
    tweights.save_darknet_weights(tvars, str(d / "port.weights"), C)
    return d, jvars, tvars


def test_save_writes_the_jax_bytes(files):
    d, _, _ = files
    got = (d / "port.weights").read_bytes()
    assert got == (d / "jax.weights").read_bytes()
    assert len(got) == 20 + 4 * tweights.expected_weight_count(C)


def test_load_round_trips_bit_for_bit(files):
    d, jvars, tvars = files
    fresh = init_yolov3(torch.Generator().manual_seed(9), C, device=CPU)
    loaded = tweights.load_darknet_weights(fresh, str(d / "jax.weights"), C)
    jloaded = jweights.load_darknet_weights(jvars, str(d / "jax.weights"), C)
    for scope, name, has_bn in darknet_layer_order(C):
        keys = [("params", "w")] + (
            [("params", "beta"), ("params", "gamma"), ("batch_stats", "mean"),
             ("batch_stats", "var")] if has_bn else [("params", "b")])
        for part, key in keys:
            got = loaded[part][scope][name][key]
            assert got.dtype == torch.float32
            assert torch.equal(got, tvars[part][scope][name][key])
            want = np.asarray(jloaded[part][scope][name][key])
            if key == "w":                         # HWIO -> OIHW
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(got.numpy(), want)
    tweights.save_darknet_weights(loaded, str(d / "again.weights"), C)
    assert (d / "again.weights").read_bytes() == \
        (d / "port.weights").read_bytes()
    (d / "again.weights").unlink()


@pytest.mark.parametrize("extra,match", [(-1000, "too short"),
                                         (7, "unread")])
def test_wrong_size_file_rejected(files, extra, match):
    d, _, tvars = files
    blob = (d / "port.weights").read_bytes()
    path = d / f"bad{extra}.weights"
    if extra < 0:
        path.write_bytes(blob[:4 * extra])
    else:
        path.write_bytes(blob + np.zeros(extra, np.float32).tobytes())
    with pytest.raises(ValueError, match=match):
        tweights.load_darknet_weights(tvars, str(path), C)
    path.unlink()


@pytest.mark.parametrize("num_classes", [2, 20, 80])
def test_expected_weight_count_matches_jax(num_classes):
    assert tweights.expected_weight_count(num_classes) == \
        jweights.expected_weight_count(num_classes)
