from .clip import CLIPConfig, CLIPModel, enable_fused_inference
from .decoder_head import RNNDecoderConfig, RNNDecoderHead
from .caption_transformer import CaptionConfig, CaptionTransformer
from .recognizer import Recognizer3D, Recognizer3DCaption, Recognizer3DRelseq
from .timesformer import TimeSformer, TimeSformerConfig
from .yolo import YoloClassifier, YoloConfig, YoloV5
