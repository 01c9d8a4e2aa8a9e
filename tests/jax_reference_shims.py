"""Test-local patches that let the JAX reference's fused datapath and GIN
run on the CPU under the installed JAX, for the port's tests.

* ``jax.experimental.pallas.load`` is gone from newer JAX; the reference's
  interpret-mode densify (``repro/kernels/aggregate.py:_stream_densify_tile``)
  still calls it, so it is supplied as ``ref[idx]``.
* GIN's ``repro.gnn.models._pinned_mul`` pins a rounding through
  ``jax.pure_callback(..., vectorized=True)``, which newer JAX refuses; it
  becomes the plain product.

Both patches live only for one test, and the fixture clears JAX's caches
on the way out, so that no trace made under them outlives the test (the
reference's own tests, run later in the same worker, must see JAX as it
is). A test module takes the fixture with
``from jax_reference_shims import jax_shims  # noqa: F401``.
"""
import pytest


@pytest.fixture
def jax_shims(monkeypatch):
    import jax
    import jax.experimental.pallas as pl

    import repro.gnn.models as jm
    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(jm, "_pinned_mul", lambda a, b: a * b)
    yield
    jax.clear_caches()
