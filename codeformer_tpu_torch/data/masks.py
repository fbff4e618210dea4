"""Inpainting mask generators (reference: basicsr/data/data_util.py:310-391
brush_stroke_mask / random_ff_mask)."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw


def brush_stroke_mask(img: Image.Image, color=(255, 255, 255)
                      ) -> Image.Image:
    """Paint random white brush strokes onto a PIL image
    (data_util.py:310-362 semantics: random vertices with arc-like angles,
    thick joined lines + end-cap ellipses)."""
    min_num_vertex = 8
    max_num_vertex = 28
    mean_angle = 2 * math.pi / 5
    angle_range = 2 * math.pi / 15
    min_width = 12
    max_width = 80

    w, h = img.size
    average_radius = math.sqrt(h * h + w * w) / 8
    mask = img.copy()
    draw = ImageDraw.Draw(mask)

    for _ in range(np.random.randint(1, 4)):
        num_vertex = np.random.randint(min_num_vertex, max_num_vertex)
        angle_min = mean_angle - np.random.uniform(0, angle_range)
        angle_max = mean_angle + np.random.uniform(0, angle_range)
        angles = []
        for i in range(num_vertex):
            if i % 2 == 0:
                angles.append(2 * math.pi
                              - np.random.uniform(angle_min, angle_max))
            else:
                angles.append(np.random.uniform(angle_min, angle_max))

        vertex = [(int(np.random.randint(0, w)),
                   int(np.random.randint(0, h)))]
        for angle in angles:
            r = np.clip(np.random.normal(loc=average_radius,
                                         scale=average_radius // 2),
                        0, 2 * average_radius)
            new_x = np.clip(vertex[-1][0] + r * math.cos(angle), 0, w)
            new_y = np.clip(vertex[-1][1] + r * math.sin(angle), 0, h)
            vertex.append((int(new_x), int(new_y)))

        width = int(np.random.uniform(min_width, max_width))
        draw.line(vertex, fill=color, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2, v[1] - width // 2,
                          v[0] + width // 2, v[1] + width // 2),
                         fill=color)
    return mask


def random_ff_mask(shape: Tuple[int, int], max_angle: float = 10,
                   max_len: int = 150, max_width: int = 50,
                   times: int = 10) -> np.ndarray:
    """Free-form stroke binary mask (data_util.py:365-391)."""
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    times = np.random.randint(times - 5, times)
    for _ in range(times):
        start_x = np.random.randint(w)
        start_y = np.random.randint(h)
        for j in range(1 + np.random.randint(5)):
            angle = 0.01 + np.random.randint(max_angle)
            if j % 2 == 0:
                angle = 2 * math.pi - angle
            length = 10 + np.random.randint(max_len)
            brush_w = 5 + np.random.randint(max_width)
            end_x = (start_x + length * np.sin(angle)).astype(np.int64)
            end_y = (start_y + length * np.cos(angle)).astype(np.int64)
            import cv2
            cv2.line(mask, (start_y, start_x), (end_y, end_x), 1.0,
                     brush_w)
            start_x, start_y = end_x, end_y
    return mask.reshape((1,) + mask.shape).astype(np.float32)
