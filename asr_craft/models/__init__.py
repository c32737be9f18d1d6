"""Model layer: CRF config/params, feature maps, topologies, weight files.

Replaces the reference's ``CRF_Model`` + ``CRF/ftrmaps/`` hierarchy
(SURVEY.md §2.1) with dataclass configs and pure functions over parameter
pytrees.
"""
from asr_craft.models.crf import (CrfConfig, crf_loss, decode,
                                  frame_accuracy, frame_posteriors,
                                  potentials)
from asr_craft.models.feature_map import (FeatureMapConfig,
                                          dense_potentials,
                                          sparse_potentials)
from asr_craft.models.topology import Topology
from asr_craft.models import weights
