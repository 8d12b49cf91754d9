"""Launch layer of the port (counterpart of ``repro/launch``): the
production mesh (``mesh``), the cells and train steps (``steps``), the
fault-tolerant trainer (``train``), the dry run over every cell
(``dryrun``) and its roofline terms on the H100 (``roofline``), and the
deprecated ``BatchingServer`` shim (``serve``)."""
