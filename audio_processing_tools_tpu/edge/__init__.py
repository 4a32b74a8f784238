"""Migration shims: the reference's ``edge.*`` module paths.

Users of ``audio_processing_tools.edge.<module>`` can switch imports to
``audio_processing_tools_tpu.edge.<module>`` and find the same names; each
shim re-exports from the accelerator-native implementation modules.
"""
