"""Host-side alias for ca3d content generation (counterpart of
clap_tpu/scene/ca3d_host.py; the implementation lives with the CA ops)."""
from ..ops.ca3d import ca3d_make_np as ca3d_make_host  # noqa: F401
