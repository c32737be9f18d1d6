"""Hand-written GPU kernels.

``fdt_triton``: the factored frame-dependent-transition recursions (alpha,
beta, max-plus with traceback) as Pallas kernels on the Triton route.
:func:`asr_craft.ops.fdt.recursion_impl` decides where they run.
"""
