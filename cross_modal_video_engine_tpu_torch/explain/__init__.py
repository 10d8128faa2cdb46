from .grads import grad_extract, add_capture_methods
from .gradcam import gradcam_from_tokens
from .ctv import (
    build_instance_ctvs, concept_scores, cluster_concept_vectors,
    symbolic_concept_vectors, tcav_statistics, top_concepts,
    concept_robustness,
)
from .probing import linear_probe_concepts
from .cbm import ResidualHead, ConceptBottleneckConfig
