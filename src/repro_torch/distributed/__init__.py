"""Distribution substrate: sharding rules, pipeline stages, compression.

``sharding`` (logical axis rules, DTensor placements on a
``torch.distributed`` DeviceMesh), ``pipeline`` (stages over the pod
axis), ``compression`` (int8 + error feedback for the backprop
baseline) and ``world`` (file-store and fake process groups)."""
