"""SAM mask decoder in PyTorch: two-way transformer, upscaling with the
high-resolution skips, hypernetwork masks, and the eval-mode
single/multi-mask stability fallback.

Counterpart of the JAX package's `models/sam2/decoder.py`, NHWC at its
boundary like the JAX module.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MLP, LayerNorm


class Attention(nn.Module):
    """SAM attention with internal-dim downsampling."""

    def __init__(self, embedding_dim=256, num_heads=8, downsample_rate=1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.internal, self.num_heads = internal, num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        hd = self.internal // self.num_heads

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], self.num_heads, hd)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        attn = torch.softmax(attn / (hd ** 0.5), dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], self.internal))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim=256, num_heads=8, mlp_dim=2048,
                 attention_downsample_rate=2, skip_first_layer_pe=False):
        super().__init__()
        d = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(d, num_heads)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.cross_attn_token_to_image = Attention(d, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.mlp_lin1 = nn.Linear(d, mlp_dim)
        self.mlp_lin2 = nn.Linear(mlp_dim, d)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.cross_attn_image_to_token = Attention(d, num_heads, attention_downsample_rate)
        self.norm4 = LayerNorm(d, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        y = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries + y)
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth=2, embedding_dim=256, num_heads=8, mlp_dim=2048):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layers_{i}", TwoWayAttentionBlock(
                embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0)))
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads, 2)
        self.norm_final_attn = LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(-1, h * w, c).expand(b, h * w, c)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """SAM2 mask decoder (object-score token variant)."""

    def __init__(self, transformer_dim=256, mlp_dim=2048, num_multimask_outputs=3,
                 iou_head_depth=3, iou_head_hidden_dim=256, pred_obj_scores=True,
                 pred_obj_scores_mlp=True, use_high_res_features=True,
                 dynamic_multimask_via_stability=True,
                 dynamic_multimask_stability_delta=0.05,
                 dynamic_multimask_stability_thresh=0.98):
        super().__init__()
        d = transformer_dim
        nm = num_multimask_outputs + 1
        self.num_mask_tokens = nm
        self.pred_obj_scores = pred_obj_scores
        self.use_high_res_features = use_high_res_features
        self.dynamic = dynamic_multimask_via_stability
        self.delta = dynamic_multimask_stability_delta
        self.thresh = dynamic_multimask_stability_thresh
        self.iou_token = nn.Parameter(torch.zeros(1, d))
        self.mask_tokens = nn.Parameter(torch.zeros(nm, d))
        if pred_obj_scores:
            self.obj_score_token = nn.Parameter(torch.zeros(1, d))
            # scored by the JAX module but never consumed by the image
            # path; kept so the weight trees match
            self.pred_obj_score_head = (MLP(d, d, 1, 3) if pred_obj_scores_mlp
                                        else nn.Linear(d, 1))
        self.transformer = TwoWayTransformer(2, d, 8, mlp_dim)
        self.output_upscaling_0 = nn.ConvTranspose2d(d, d // 4, 2, 2)
        self.output_upscaling_1 = LayerNorm(d // 4, eps=1e-6)
        self.output_upscaling_3 = nn.ConvTranspose2d(d // 4, d // 8, 2, 2)
        for i in range(nm):
            self.add_module(f"output_hypernetworks_mlps_{i}", MLP(d, d, d // 8, 3))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim, nm, iou_head_depth,
                                       sigmoid_output=True)

    def forward(self, image_embeddings, image_pe, sparse, dense, high_res_features):
        """Single-mask output with the stability fallback: returns
        (masks (B, 1, 4h, 4w) float32, iou (B, 1) float32)."""
        b, h, w, d = image_embeddings.shape
        nm = self.num_mask_tokens
        dt = image_embeddings.dtype
        toks = [self.iou_token, self.mask_tokens]
        s = 0
        if self.pred_obj_scores:
            toks, s = [self.obj_score_token] + toks, 1
        output_tokens = torch.cat(toks, dim=0)[None].expand(b, -1, d).to(dt)
        sparse = sparse.expand(b, sparse.shape[1], d).to(dt)
        tokens = torch.cat([output_tokens, sparse], dim=1)

        src = image_embeddings + dense.to(dt)
        hs, src_out = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1 : s + 1 + nm]

        up1 = self.output_upscaling_0(src_out.reshape(b, h, w, d).permute(0, 3, 1, 2))
        up1 = up1.permute(0, 2, 3, 1)
        feat_s0, feat_s1 = high_res_features
        if self.use_high_res_features:
            up1 = up1 + feat_s1.to(up1.dtype)
        up1 = F.gelu(self.output_upscaling_1(up1))
        up2 = self.output_upscaling_3(up1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.use_high_res_features:
            up2 = up2 + feat_s0.to(up2.dtype)
        upscaled = F.gelu(up2)

        hyper = torch.stack(
            [getattr(self, f"output_hypernetworks_mlps_{i}")(mask_tokens_out[:, i])
             for i in range(nm)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out).float()
        if self.dynamic:
            return self._stability_select(masks, iou_pred)
        return masks[:, 0:1], iou_pred[:, 0:1]

    def _stability_select(self, masks, iou_pred):
        """Replace an unstable single-mask output with the best multimask
        (sam2 _dynamic_multimask_via_stability)."""
        multi_masks, multi_iou = masks[:, 1:], iou_pred[:, 1:]
        best = torch.argmax(multi_iou, dim=-1)
        idx = torch.arange(masks.shape[0], device=masks.device)
        best_masks = multi_masks[idx, best][:, None]
        best_iou = multi_iou[idx, best][:, None]
        single = masks[:, 0:1]
        area_i = torch.sum(single > self.delta, dim=(-1, -2)).float()
        area_u = torch.sum(single > -self.delta, dim=(-1, -2)).float()
        stability = torch.where(area_u > 0, area_i / torch.clamp(area_u, min=1.0), 1.0)
        is_stable = stability >= self.thresh
        out_masks = torch.where(is_stable[..., None, None], single, best_masks)
        out_iou = torch.where(is_stable, iou_pred[:, 0:1], best_iou)
        return out_masks, out_iou
