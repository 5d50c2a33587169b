"""The port's PIL host generator (``rlcf_torch/data/augmix_host.py``) against
``rlcf_tpu/data/augmix_host.py``: for the same numpy seed, the same views
exactly (augmix on and off, the BYOL hard recipe, severities 1 and 2, a
non-square source). The affine ops write ``IMAGE_SIZE`` (224) px views in
both packages, so the views are 224 px."""

import numpy as np
import pytest

from rlcf_tpu.data import augmix_host as J
from rlcf_torch.data import augmix_host as T


@pytest.mark.parametrize("augmix,hard_aug,severity,shape", [
    (True, False, 1.0, (48, 48)), (False, False, 1.0, (48, 48)), (True, True, 1.0, (40, 56)),
    (False, True, 1.0, (56, 40)), (True, False, 2.0, (48, 64))])
def test_generate_views_host_equals_jax(augmix, hard_aug, severity, shape):
    img = np.random.default_rng(3).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    kw = dict(n_views=6, resolution=T.IMAGE_SIZE, augmix=augmix, severity=severity, hard_aug=hard_aug)
    got = T.generate_views_host(img, rng=np.random.default_rng(11), **kw)
    want = J.generate_views_host(img, rng=np.random.default_rng(11), **kw)
    assert got.shape == want.shape == (6, 224, 224, 3) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_default_rng_and_ops_list_match():
    img = np.random.default_rng(5).integers(0, 256, size=(40, 40, 3), dtype=np.uint8)
    np.testing.assert_array_equal(T.generate_views_host(img, 3), J.generate_views_host(img, 3))
    assert [f.__name__ for f in T.AUGMENTATIONS] == [f.__name__ for f in J.AUGMENTATIONS]
