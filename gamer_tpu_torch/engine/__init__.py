"""Render engine: scene prep, the march and its epilogue, and the fits."""

_FIT_NAMES = (
    "fit_scene", "fit_pose", "fit_pose_fd", "fit_scene_fd",
    "fit_scene_multiscale", "fit_pose_multiscale", "fit_scene_batch",
    "fit_scene_multiview", "fit_joint", "fit_joint_multiview",
    "apply_fit_to_scene", "FitResult", "BatchFitResult",
    "JointMultiviewResult",
)


def __getattr__(name):
    # the fits on first use, as gamer_tpu.engine exports them
    if name in _FIT_NAMES:
        from . import fit

        return getattr(fit, name)
    raise AttributeError(name)
