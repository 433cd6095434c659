"""Host-side mesh rendering (``multihmr_tpu/render``): overlays, side views,
rotating videos, .obj and .glb export."""

from multihmr_tpu_torch.render.render import (  # noqa: F401
    render_meshes,
    overlay_human_meshes,
    export_obj,
    create_glb_scene,
    print_distance_on_image,
    get_bbox,
)
from multihmr_tpu_torch.render.color import demo_color  # noqa: F401
from multihmr_tpu_torch.render.views import (  # noqa: F401
    render_side_views,
    create_rotating_video,
    render_view_from_angle,
)
