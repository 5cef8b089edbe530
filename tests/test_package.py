"""Any other top-level `dustraytracer*` package in the checkout is an
alias of `dustraytracer` (a former import name): importing a module
through it returns the package's own module object."""

import importlib
import os
import pkgutil

import pytest

import dustraytracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    dustraytracer.__file__)))
ALIASES = sorted(m.name for m in pkgutil.iter_modules([ROOT])
                 if m.ispkg and m.name.startswith("dustraytracer")
                 and m.name != "dustraytracer")


def test_an_alias_exists():
    assert ALIASES


@pytest.mark.parametrize("sub", ["scene.settings", "render.integrator",
                                 "ops.traverse_kernel"])
def test_alias_returns_the_same_modules(sub):
    new = importlib.import_module(f"dustraytracer.{sub}")
    for alias in ALIASES:
        old = importlib.import_module(f"{alias}.{sub}")
        assert old is new
        assert old.__name__ == old.__spec__.name == f"dustraytracer.{sub}"
        assert importlib.import_module(alias) is dustraytracer
