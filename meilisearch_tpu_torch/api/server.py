"""HTTP server for the port: the reference server with the port's App.

Run: `python -m meilisearch_tpu_torch.api.server --port 7700` (the same
options as `python -m meilisearch_tpu.api.server`). It serves keyword
search on CUDA, refuses to start without a GPU, and never loads jax.
"""

from __future__ import annotations

from meilisearch_tpu.api import server as _ref

from .._hooks import block_jax, rebind_globals
from .app import App

# the reference's option parsing, restore and socket loop, building the
# port's App
_serve_main = rebind_globals(_ref.main, App=App)


def main():
    block_jax()
    _serve_main()


if __name__ == "__main__":
    main()
