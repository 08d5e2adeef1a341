"""Design-YAML resolution for the port's entry points and tests.

Named designs resolve to the YAML files vendored beside the JAX package
(``raft_tpu/designs/``), read here as data by file path; a path to any
``.yaml`` file works too.
"""
from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: search roots, in priority order: a designs/ directory at the repo
#: root (user overrides in a source checkout), then the vendored YAMLs
_SEARCH_DIRS = (
    os.path.join(_REPO, "designs"),
    os.path.join(_REPO, "raft_tpu", "designs"),
)


def design_path(name_or_path: str) -> str:
    """Absolute path of a design YAML, by name (e.g. 'VolturnUS-S') or
    by path."""
    if os.path.isfile(name_or_path):
        return os.path.abspath(name_or_path)
    fname = name_or_path if name_or_path.endswith((".yaml", ".yml")) \
        else name_or_path + ".yaml"
    for root in _SEARCH_DIRS:
        path = os.path.join(root, fname)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"design '{fname}' not found in {list(_SEARCH_DIRS)}")


def load_design(name_or_path: str) -> dict:
    """Load a design YAML (by name or path) into a dict."""
    import yaml
    with open(design_path(name_or_path)) as f:
        return yaml.safe_load(f)
