"""The port's package exports against the JAX package's.

Every name in the ``__all__`` of ``tpu_search`` and of each of its
subpackages imports from the same place in ``tpu_search_torch``, or is a
stated exception below with the reason it is left out; every subpackage
of ``tpu_search`` exists in the port, or is a stated exception.
"""

import importlib
import pkgutil

import pytest

import tpu_search

# (package, name): why the port does not export it.
EXCEPTIONS = {
    ("models", "encode"): "MPNetModel.forward",
    ("models", "forward_hidden"): "MPNetModel.forward_hidden",
    ("models", "classify"): "MPNetModel.classify",
    ("ops", "flat_topk"): "the JAX scan functions; the port's are "
                          "ops.flat_topk.flat_topk_scan",
    ("ops", "flat_topk_int8"): "ops.flat_topk_int8.flat_topk_int8_scan",
}
# Subpackages of tpu_search the port does not have, and why.
MISSING_PACKAGES: dict = {}
PACKAGES = sorted(m.name for m in pkgutil.iter_modules(tpu_search.__path__)
                  if m.ispkg)


def _exported(package: str):
    ref = importlib.import_module(f"tpu_search.{package}".rstrip("."))
    return list(getattr(ref, "__all__", []))


def _imports(package: str, name: str) -> bool:
    mod = importlib.import_module(f"tpu_search_torch.{package}".rstrip("."))
    if hasattr(mod, name):
        return True
    try:  # a submodule named in __all__ (interfaces.cli)
        importlib.import_module(f"{mod.__name__}.{name}")
        return True
    except ImportError:
        return False


@pytest.mark.parametrize("package", ["", *PACKAGES])
def test_every_reference_export_is_ported_or_excepted(package):
    if package in MISSING_PACKAGES:
        with pytest.raises(ImportError):
            importlib.import_module(f"tpu_search_torch.{package}")
        return
    missing = [name for name in _exported(package)
               if (package, name) not in EXCEPTIONS
               and not _imports(package, name)]
    assert not missing, f"tpu_search_torch.{package} lacks {missing}"


def test_exceptions_name_real_reference_exports():
    for package, name in EXCEPTIONS:
        assert name in _exported(package), (package, name)
    assert set(MISSING_PACKAGES) <= set(PACKAGES)


def test_api_exports_the_engine():
    from tpu_search_torch.api import (  # noqa: F401
        DEFAULT_DATA_DIR,
        SearchEngine,
        SemanticSearchCLI,
        resolve_data_dir,
    )
    from tpu_search_torch.api.engine import SearchEngine as Engine

    assert SearchEngine is Engine


def test_models_export_hashing_and_unigram():
    from tpu_search_torch.models import HashingEncoder, UnigramTokenizer
    from tpu_search_torch.models.hashing import HashingEncoder as H
    from tpu_search_torch.models.sp_tokenizer import UnigramTokenizer as U

    assert HashingEncoder is H and UnigramTokenizer is U
