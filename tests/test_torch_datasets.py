"""The port's ``datasets`` against the JAX package's: the same files,
read in place from ``particles_tpu/data/``, give the same arrays; with no
file found, the same seeded synthetic surrogates."""

import warnings

import numpy as np
import pytest

import particles_tpu.datasets as jds
from particles_tpu_torch import datasets as ds

NAMES = ["Nutria", "Neuro", "GBP_vs_USD_9798", "Boston", "Concrete", "Pima",
         "Liver", "Eeg", "Sonar"]


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_data_equal_jax(name):
    d, jd = getattr(ds, name)(), getattr(jds, name)()
    assert not d.synthetic and not jd.synthetic
    _equal(d.data, jd.data)
    np.testing.assert_array_equal(d.raw_data, jd.raw_data)
    assert ds.get_path(d.file_name) == ds.DATA_DIR / d.file_name
    assert ds.get_path(d.file_name).samefile(jds.get_path(d.file_name))


@pytest.mark.parametrize("name", NAMES)
def test_synthetic_surrogates_equal_jax(name, monkeypatch):
    for mod in (ds, jds):
        monkeypatch.setattr(mod, "_candidate_paths", lambda f: iter(()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d, jd = getattr(ds, name)(), getattr(jds, name)()
    assert d.synthetic and jd.synthetic
    assert any("SYNTHETIC" in str(w.message) for w in caught)
    _equal(d.data, jd.data)


def test_search_order_and_preprocessing(tmp_path, monkeypatch):
    monkeypatch.delenv("PARTICLES_DATA_PATH", raising=False)
    monkeypatch.setenv("PARTICLES_TPU_DATA_PATH", str(tmp_path))
    paths = list(ds._candidate_paths("x.txt"))
    assert paths == [tmp_path / "x.txt", ds.DATA_DIR / "x.txt"]
    monkeypatch.setenv("PARTICLES_DATA_PATH", str(tmp_path / "ref"))
    assert list(ds._candidate_paths("x.txt"))[-1] == tmp_path / "ref/x.txt"
    (tmp_path / "nutria.txt").write_text("1\n2\n4\n")
    np.testing.assert_array_equal(ds.Nutria().data, [1.0, 2.0, 4.0])
    assert ds.get_path("nutria.txt") == tmp_path / "nutria.txt"
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 3))
    for kw in ({}, {"add_intercept": False, "scale": 1.0}):
        np.testing.assert_array_equal(ds.prepare_predictors(X, **kw),
                                      jds.prepare_predictors(X, **kw))
    np.testing.assert_array_equal(ds.prepare_predictors(X[:, 0]),
                                  jds.prepare_predictors(X[:, 0]))
    pima = ds.Pima(return_y=True)
    _equal(pima.data, jds.Pima(return_y=True).data)
    assert pima.data[0].shape == (768, 9) and set(pima.data[1]) == {-1, 1}
