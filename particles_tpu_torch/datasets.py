"""Datasets with preprocessing, for the book and paper experiments
(PyTorch port).

Counterpart of ``particles_tpu/datasets.py``, with the same class
hierarchy — :class:`Dataset` (loading and preprocessing),
:class:`RegressionDataset` (predictors rescaled to mean 0 and std 0.5, an
intercept added), :class:`BinaryRegDataset` (the same, plus the sign-flip
trick) and :class:`LogReturnsDataset` (100 times the diff of the log) —
and the same nine datasets (Nutria, Neuro, GBP_vs_USD_9798, Boston,
Concrete, Pima, Liver, Eeg, Sonar).  ``data`` is numpy, as there: a model
takes it to the device (``torch.as_tensor(ds.data, device=...)``).

The raw files are read in place from the JAX package's data directory,
``particles_tpu/data/`` beside this package, by path (nothing of the JAX
package is imported).  Each dataset searches, in order:

1. ``$PARTICLES_TPU_DATA_PATH/<file_name>``,
2. ``particles_tpu/data/<file_name>`` (the copies in this repository),
3. ``$PARTICLES_DATA_PATH/<file_name>``.

If the raw file is nowhere to be found, a documented synthetic surrogate
with the same shape and statistical character is generated from a fixed
seed (``np.random.default_rng(20260816)``, as in the JAX package), with a
warning; the ``synthetic`` attribute records which source was used.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

# the JAX package's data directory, read in place
DATA_DIR = Path(__file__).resolve().parent.parent / "particles_tpu" / "data"

__all__ = [
    "DATA_DIR",
    "get_path",
    "prepare_predictors",
    "Dataset",
    "LogReturnsDataset",
    "RegressionDataset",
    "BinaryRegDataset",
    "Nutria",
    "Neuro",
    "GBP_vs_USD_9798",
    "Boston",
    "Concrete",
    "Pima",
    "Liver",
    "Eeg",
    "Sonar",
]


def get_path(file_name):
    """First existing candidate path for a data file (reference
    datasets.py:53-54); falls back to the data directory."""
    for c in _candidate_paths(file_name):
        if c.exists():
            return c
    return DATA_DIR / file_name


def _candidate_paths(file_name):
    env = os.environ.get("PARTICLES_TPU_DATA_PATH")
    if env:
        yield Path(env) / file_name
    yield DATA_DIR / file_name
    env2 = os.environ.get("PARTICLES_DATA_PATH")
    if env2:
        yield Path(env2) / file_name


def prepare_predictors(predictors, add_intercept=True, scale=0.5):
    """Rescale predictors to mean 0 / std ``scale``, optionally prepend an
    intercept column (reference datasets.py:153-181)."""
    preds = np.asarray(predictors, dtype=float)
    if preds.ndim == 1:
        # a single predictor: (n,) -> (n, 1).  np.atleast_2d would give a
        # (1, n) ROW, making the per-column std 0 and the rescale 0/0=NaN
        preds = preds[:, None]
    rescaled = scale * (preds - np.mean(preds, axis=0)) / np.std(preds, axis=0)
    if add_intercept:
        n, p = preds.shape
        out = np.empty((n, p + 1))
        out[:, 0] = 1.0
        out[:, 1:] = rescaled
        return out
    return rescaled


class Dataset:
    """Base class (reference datasets.py:57-72): loads ``file_name`` with
    ``load_opts`` and applies ``preprocess``."""

    load_opts = {"delimiter": ","}
    file_name = None

    def preprocess(self, raw_data, **kwargs):
        return raw_data

    def synthesize(self, rng):
        """Synthetic surrogate raw data; subclasses override."""
        raise FileNotFoundError(
            f"{type(self).__name__}: raw file {self.file_name} not found and "
            "no synthetic surrogate is defined"
        )

    def __init__(self, **kwargs):
        self.synthetic = True
        for path in _candidate_paths(self.file_name):
            if path.exists():
                self.raw_data = np.loadtxt(str(path), **self.load_opts)
                self.synthetic = False
                break
        else:
            warnings.warn(
                f"{type(self).__name__}: raw data file "
                f"{self.file_name!r} not found in any search path; using a "
                "SYNTHETIC surrogate — results will not match published "
                "numbers. Set $PARTICLES_TPU_DATA_PATH to the real data.",
                stacklevel=2,
            )
            self.raw_data = self.synthesize(np.random.default_rng(20260816))
        self.data = self.preprocess(self.raw_data, **kwargs)


class Nutria(Dataset):
    """Female nutria abundance time series (monthly), cf. Peters et al
    (2010) and the ThetaLogistic model (reference datasets.py:74-96).

    Synthetic surrogate: a theta-logistic population trajectory observed
    with noise, ~120 months.
    """

    file_name = "nutria.txt"
    load_opts = {}

    def synthesize(self, rng):
        T = 120
        logx = np.empty(T)
        logx[0] = np.log(100.0)
        for t in range(1, T):
            logx[t] = (logx[t - 1] + 0.15 - 0.12
                       * np.exp(0.1 * logx[t - 1]) * 0.1
                       + 0.2 * rng.normal())
        return np.exp(logx + 0.1 * rng.normal(size=T)).round()


class Neuro(Dataset):
    """Activated-neuron counts over 50 repeated experiments
    (Temereanca et al 2008; reference datasets.py:99-120).

    Synthetic surrogate: Binomial(50, logistic(AR(1))) counts, T=250.
    """

    file_name = "thaldata.csv"

    def synthesize(self, rng):
        T = 250
        x = np.empty(T)
        x[0] = rng.normal()
        for t in range(1, T):
            x[t] = 0.95 * x[t - 1] + 0.3 * rng.normal()
        p = 1.0 / (1.0 + np.exp(-(x - 1.0)))
        return rng.binomial(50, p).astype(float)


class LogReturnsDataset(Dataset):
    """Log-returns preprocessing: 100 * diff(log(prices))
    (reference datasets.py:126-135)."""

    def preprocess(self, raw_data, **kwargs):
        return 100.0 * np.diff(np.log(raw_data), axis=0)


class GBP_vs_USD_9798(LogReturnsDataset):
    """GBP/USD daily rates 1997-98, 751 points
    (reference datasets.py:137-147).

    Synthetic surrogate: a stochastic-volatility price path of the same
    length with parameters matching the usual fit of this series.
    """

    file_name = "GBP_vs_USD_9798.txt"
    load_opts = {"skiprows": 2, "usecols": (3,), "comments": "(C)"}

    def synthesize(self, rng):
        T = 751
        xs = np.empty(T)
        xs[0] = -1.02
        for t in range(1, T):
            xs[t] = -1.02 + 0.97 * (xs[t - 1] + 1.02) + 0.18 * rng.normal()
        rets = np.exp(0.5 * xs) * rng.normal(size=T) / 100.0
        return 1.6 * np.exp(np.cumsum(rets))


class RegressionDataset(Dataset):
    """p predictors + scalar response; preprocessing rescales and adds an
    intercept (reference datasets.py:184-200).  ``data`` = (preds, response).
    """

    n_synth, p_synth = 500, 10

    def preprocess(self, raw_data, **kwargs):
        response = raw_data[:, -1]
        preds = prepare_predictors(raw_data[:, :-1])
        return preds, response

    def synthesize(self, rng):
        n, p = self.n_synth, self.p_synth
        X = rng.normal(size=(n, p))
        beta = rng.normal(size=p) * (rng.uniform(size=p) < 0.5)
        y = X @ beta + rng.normal(size=n)
        return np.column_stack([X, y])


class Boston(RegressionDataset):
    """Boston house prices: 506 observations, 13 predictors
    (reference datasets.py:203-231)."""

    file_name = "boston_house_prices.csv"
    load_opts = {"delimiter": ",", "skiprows": 2}
    n_synth, p_synth = 506, 13


class Concrete(RegressionDataset):
    """Concrete compressive strength: 1030 observations, 8 predictors
    (reference datasets.py:234-257)."""

    file_name = "concrete.csv"
    load_opts = {"delimiter": ",", "skiprows": 1}
    n_synth, p_synth = 1030, 8


class BinaryRegDataset(Dataset):
    """Binary response; preprocessing rescales predictors, adds intercept,
    and by default applies the sign-flip trick (returns y_i * x_i)
    (reference datasets.py:260-292).  Pass ``return_y=True`` for (preds, y).
    """

    n_synth, p_synth = 500, 8

    def preprocess(self, raw_data, return_y=False, **kwargs):
        # robust -1/+1 recode: the reference's ``2*y - 1`` assumes 0/1
        # (datasets.py:287) but e.g. the raw ILPD file codes classes as 1/2
        raw_resp = raw_data[:, -1]
        response = np.where(raw_resp == np.max(raw_resp), 1.0, -1.0)
        preds = prepare_predictors(raw_data[:, :-1])
        if return_y:
            return preds, response
        return preds * response[:, np.newaxis]

    def synthesize(self, rng):
        n, p = self.n_synth, self.p_synth
        X = rng.normal(size=(n, p))
        beta = rng.normal(size=p)
        logits = X @ beta
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(float)
        return np.column_stack([X, y])


class Pima(BinaryRegDataset):
    """Pima Indians diabetes: 768 observations, 8 predictors
    (reference datasets.py:295-317)."""

    file_name = "pima-indians-diabetes.data"
    n_synth, p_synth = 768, 8


class Liver(BinaryRegDataset):
    """Indian liver patient dataset: 579 observations, 10 predictors
    (reference datasets.py:319-344)."""

    file_name = "indian_liver_patient.csv"
    n_synth, p_synth = 579, 10


class Eeg(BinaryRegDataset):
    """EEG (alcoholic vs control): 122 observations, 64 predictors
    (reference datasets.py:346-361)."""

    file_name = "eeg_eye_state.data"
    load_opts = {"delimiter": ",", "skiprows": 19}
    n_synth, p_synth = 122, 64


class Sonar(BinaryRegDataset):
    """Sonar (rock vs mine): ~208 observations, 60 predictors
    (reference datasets.py:363-377)."""

    file_name = "sonar.all-data"
    load_opts = {
        "delimiter": ",",
        "converters": {60: lambda x: 1 if x in (b"R", "R") else 0},
    }
    n_synth, p_synth = 208, 60
