"""Model repository: JetStream-style Object Store + local model cache.

Copy of ``nats_llm_studio_tpu/store``: a server-side store module on the
embedded broker speaking the public JetStream wire subjects (``$JS.API.>``,
``$O.<bucket>.>``) and a model manager keeping the on-disk cache layout
``<models_dir>/<publisher>/<model>/``.
"""

from .manager import ModelStore
from .objectstore import JetStreamStoreModule

__all__ = ["ModelStore", "JetStreamStoreModule"]
