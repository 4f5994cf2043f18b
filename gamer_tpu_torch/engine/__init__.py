"""Render engine: scene prep, the XLA-form march and its epilogue, the
kernel paths (cuda_render, batch, allsky, queue) and the fits."""

from .render import post_process, render_rays, render_scene  # noqa: F401
from .scene_prep import SceneStatic, flatten_scene  # noqa: F401

_FIT_NAMES = (
    "fit_scene", "fit_pose", "fit_pose_fd", "fit_scene_fd",
    "fit_scene_multiscale", "fit_pose_multiscale", "fit_scene_batch",
    "fit_scene_multiview", "fit_joint", "fit_joint_multiview",
    "apply_fit_to_scene", "FitResult", "BatchFitResult",
    "JointMultiviewResult",
)
_DIFF_NAMES = (
    "render_rays_diff", "render_frame_diff", "post_process_float",
    "safe_pow", "conservative_step_bound", "step_bound_for_scene",
)


def __getattr__(name):
    # the fits and the differentiable marches on first use, as
    # gamer_tpu.engine exports them
    if name in _FIT_NAMES:
        from . import fit

        return getattr(fit, name)
    if name in _DIFF_NAMES:
        from . import diff

        return getattr(diff, name)
    raise AttributeError(name)
