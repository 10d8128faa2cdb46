from .clip import CLIPConfig, CLIPModel, enable_fused_inference
