"""lif_tpu: a JAX (XLA + Pallas) light-field-image view-synthesis
framework.

Re-creation of the capabilities of the LIF-renderer reference library
(THREE.js/WebGL) as pure jit-compiled functions of
(scene arrays, camera) -> image, batched by broadcasting and sharded over
device meshes.

Public surface mirrors the reference's exports (reference: src/index.ts:4-19):
  HoloProjector            -> Projector / projector_from_arrays
  HoloRenderer             -> render / render_mono_view / render_stereo_view
  HoloLayerGroup           -> models.scene.LayerGroup
  RaycastPlane             -> (subsumed by the pure render functions)
  LifLoader, loadLifFile   -> LifLoader, load_lif_file
  lifRotationToQuaternion  -> lif_rotation_to_quaternion / _matrix
  createHoloProjectorFromLifView -> projector_from_lif_view
"""

__version__ = "0.2.0"

from .core.camera import Camera  # noqa: F401
from .core.pose import (  # noqa: F401
    lif_rotation_to_matrix,
    lif_rotation_to_quaternion,
    orbit_pose,
)
from .models.api import (  # noqa: F401
    LifLoader,
    LoadLifFileResult,
    load_lif_file,
    synthesize_projector,
)
from .models.projector import (  # noqa: F401
    Projector,
    projector_from_arrays,
    resample_projector,
    projector_from_lif_view,
)
from .config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
from .models.renderer import (  # noqa: F401
    RenderMode,
    render,
    render_fast_batch,
    render_depth_fast,
    render_fused_fast,
    render_fused_fast_batch,
    render_fast_view,
    render_mono_view,
    render_stereo_fast,
    render_stereo_fast_batch,
    render_stereo_view,
)
from .models.api import orbit_center_from_stereo_data  # noqa: F401
