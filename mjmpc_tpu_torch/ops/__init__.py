from .control import (
    clip_ctrl,
    cost_to_go,
    discount_matrix,
    gamma_sequence,
    gaussian_entropy,
    gaussian_kl,
    gaussian_logprob,
    gaussian_logprobgrad,
    scale_ctrl,
)
from .noise import (FilteredNoise, PhiloxUniforms, ar_filter, colour, filtered_noise,
                    standard_normals, uniforms)

__all__ = [
    "clip_ctrl",
    "cost_to_go",
    "discount_matrix",
    "gamma_sequence",
    "gaussian_entropy",
    "gaussian_kl",
    "gaussian_logprob",
    "gaussian_logprobgrad",
    "scale_ctrl",
    "FilteredNoise",
    "PhiloxUniforms",
    "ar_filter",
    "colour",
    "filtered_noise",
    "standard_normals",
    "uniforms",
]
