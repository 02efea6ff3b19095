"""The canonical 45-dimensional THA4 pose layout.

Index map (reference: src/tha4/poser/modes/pose_parameters.py:4-36):
  0-11  eyebrow (6 groups x L/R)
  12-23 eye (6 groups x L/R)
  24-25 iris_small L/R
  26-34 mouth (aaa iii uuu eee ooo delta, lowered_corner L/R, raised_corner L/R, smirk)
  35-36 iris_rotation x/y       range (-1, 1)
  37-39 head_x head_y neck_z    range (-1, 1)
  40-41 body_y body_z           range (-1, 1)
  42    breathing               range (0, 1)

(The arity-2 mouth corners make mouth span indices 29-34; total 45.)
mouth_aaa defaults to 1.0; everything else to 0.
"""

from tha4_tpu_torch.poser.poser import PoseParameterCategory, PoseParameters

NUM_POSE_PARAMETERS = 45
NUM_EYEBROW_PARAMS = 12
NUM_FACE_PARAMS = 27
NUM_ROTATION_PARAMS = 6


def get_pose_parameters() -> PoseParameters:
    return (
        PoseParameters.Builder()
        .add_parameter_group("eyebrow_troubled", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eyebrow_angry", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eyebrow_lowered", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eyebrow_raised", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eyebrow_happy", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eyebrow_serious", PoseParameterCategory.EYEBROW, arity=2)
        .add_parameter_group("eye_wink", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("eye_happy_wink", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("eye_surprised", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("eye_relaxed", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("eye_unimpressed", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("eye_raised_lower_eyelid", PoseParameterCategory.EYE, arity=2)
        .add_parameter_group("iris_small", PoseParameterCategory.IRIS_MORPH, arity=2)
        .add_parameter_group("mouth_aaa", PoseParameterCategory.MOUTH, arity=1, default_value=1.0)
        .add_parameter_group("mouth_iii", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("mouth_uuu", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("mouth_eee", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("mouth_ooo", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("mouth_delta", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("mouth_lowered_corner", PoseParameterCategory.MOUTH, arity=2)
        .add_parameter_group("mouth_raised_corner", PoseParameterCategory.MOUTH, arity=2)
        .add_parameter_group("mouth_smirk", PoseParameterCategory.MOUTH, arity=1)
        .add_parameter_group("iris_rotation_x", PoseParameterCategory.IRIS_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("iris_rotation_y", PoseParameterCategory.IRIS_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("head_x", PoseParameterCategory.FACE_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("head_y", PoseParameterCategory.FACE_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("neck_z", PoseParameterCategory.FACE_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("body_y", PoseParameterCategory.BODY_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("body_z", PoseParameterCategory.BODY_ROTATION, arity=1, range=(-1.0, 1.0))
        .add_parameter_group("breathing", PoseParameterCategory.BREATHING, arity=1, range=(0.0, 1.0))
        .build()
    )
