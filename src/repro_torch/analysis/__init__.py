"""Cost analysis of a traced call (the port's ``repro/analysis``): FLOPs,
bytes and live memory (:mod:`.flops`), the collective inventory
(:mod:`.hlo`) and the roofline on an NVIDIA H100 (:mod:`.roofline`)."""
