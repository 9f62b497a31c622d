"""Serving entry points of the port.

* ``streaming``: ``StreamingRAVE`` (chunked streaming over explicit
  caches, ``process_file_scan``'s CUDA graph, ``serialize`` to
  ``torch.export`` programs and the JAX package's manifests), the
  ``export`` command;
* ``voice_conversion``: ``VoiceConverter`` and its ``serialize``
  (``convert``, ``spk_embed``, ``convert_pg``);
* ``realtime``: ``RealtimeHost`` over the lock-free ring buffer;
* ``native``: an exported step compiled into an AOTInductor package and
  served by the C++ host ``csrc/aoti_host.cpp`` with no Python
  (``python -m rave_tpu_torch.export.native <export_dir>`` compiles the
  packages and builds the host).
"""
