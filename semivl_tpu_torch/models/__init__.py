"""Flagship model: MaskClipViT encoder, VLG decoder, VLM segmentor."""
