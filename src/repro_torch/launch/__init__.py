"""Launch layer of the port (counterpart of ``repro/launch``).  Ported so
far: the Hopper roofline terms (``roofline``) and the deprecated
``BatchingServer`` shim (``serve``)."""
