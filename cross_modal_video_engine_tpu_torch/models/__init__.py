from .clip import CLIPConfig, CLIPModel, enable_fused_inference
from .decoder_head import RNNDecoderConfig, RNNDecoderHead
from .caption_transformer import CaptionConfig, CaptionTransformer
from .mvit import MViT, MViTConfig
from .recognizer import (Recognizer3D, Recognizer3DCaption, Recognizer3DCLIP,
                         Recognizer3DRelseq)
from .swin3d import Swin3D, Swin3DConfig
from .timesformer import TimeSformer, TimeSformerConfig
from .videoclip import VideoCLIP, VideoCLIPConfig
from .videomae_vit import VideoMAEConfig, VideoMAEViT
from .yolo import YoloClassifier, YoloConfig, YoloV5
from .ava_head import AVARoIHead, AVAHeadConfig, roi_align, ava_bbox_loss
from .lfb import (ACRNHead, ACRNHeadConfig, FBOAvg, FBOHead, FBOHeadConfig,
                  FBOMax, FBONonLocal, LFBBuilder, LongTermFeatureBank,
                  NonLocalLayer)
