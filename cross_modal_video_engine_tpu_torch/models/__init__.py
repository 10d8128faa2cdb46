from .clip import CLIPConfig, CLIPModel, enable_fused_inference
from .decoder_head import RNNDecoderConfig, RNNDecoderHead
from .recognizer import Recognizer3D, Recognizer3DRelseq
from .timesformer import TimeSformer, TimeSformerConfig
from .yolo import YoloClassifier, YoloConfig, YoloV5
