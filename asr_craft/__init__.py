"""asr_craft — CRF speech recognition framework in JAX.

A from-scratch JAX/XLA/Pallas/pjit framework with the capabilities of the
OSU-slatelab/ASR-CRaFT C++ toolkit (linear-chain and segmental CRFs over
frame-level acoustic features; forward-backward training; Viterbi / beam /
FST-lattice decoding), re-designed for accelerators:

- dense padded ``(batch, time, label)`` tensor programs instead of
  pointer-chasing per-frame lattice node objects,
- ``lax.scan`` / ``lax.associative_scan`` DP recursions and Pallas kernels
  with fused log-sum-exp instead of scalar C++ loops,
- batched jit-compiled forward-backward instead of per-utterance SGD,
- ``jax.sharding`` data-parallel training and time-sharded decode with
  collective boundary exchange instead of a single-process runtime.

Capability parity map (reference components are reconstructed in
``SURVEY.md`` §2 — the reference mount was empty, so upstream paths like
``CRF/CRF_Model.{h,cpp}`` are cited by name, not line):

====================================  =======================================
Reference (C++)                        Here
====================================  =======================================
``CRF/CRF.h`` log-add helpers          :mod:`asr_craft.ops.semiring`
``CRF/CRF_Model``                      :mod:`asr_craft.models.crf`
``CRF/ftrmaps/CRF_StdFeatureMap``      :mod:`asr_craft.models.feature_map`
``CRF/nodes/CRF_Std*StateNode``        :mod:`asr_craft.ops.fwdbwd` (+ topology)
``CRF/nodes/CRF_StdSegStateNode*``     :mod:`asr_craft.ops.segmental`
``CRF/trainers/CRF_*``                 :mod:`asr_craft.train`
``CRF/decoders/CRF_ViterbiDecoder``    :mod:`asr_craft.decode`
``CRF/decoders/CRF_LatticeBuilder``    :mod:`asr_craft.decode.lattice`
``CRF/io/CRF_FeatureStream*``          :mod:`asr_craft.data`
``CRFTrain.cpp`` / ``CRFFstDecode``    :mod:`asr_craft.cli`
(absent: distributed runtime)          :mod:`asr_craft.parallel`
====================================  =======================================
"""

__version__ = "0.1.0"
