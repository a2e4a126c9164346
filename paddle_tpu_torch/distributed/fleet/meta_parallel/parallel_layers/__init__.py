from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                        SharedLayerDesc, dropout_seed)

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "dropout_seed"]
