"""Whole-image and video path of the port's CLI, counterpart of
codeformer_tpu/cli/whole_image.py (the reference's main loop,
inference_codeformer.py:160-272).

Two routes, chosen as the JAX CLI chooses them (`--fused_pipeline`):
- the fused device pipeline (pipeline/device_pipeline.py) for a folder of
  same-size colour images or a video with a RetinaFace detector and no
  upsampler: frames stay on the device between detect, align, restore,
  parse and paste; a video streams through it chunk by chunk to the
  writer;
- the classic per-stage path for everything else it serves (gray
  images, mixed sizes, --draw_box, a YOLOv5 detector, the Real-ESRGAN
  upsamplers, --fused_pipeline off): per image, read, detect and align
  on the host (cv2); ONE restoration stream over the faces of every
  image; gray adaptation, then ONE parsing stream (with --face_upsample
  each image's upsampled faces are parsed at its paste, as the
  reference parses them); per image, the background upsample
  (--bg_upsampler realesrgan), paste back (the device compositor, or
  cv2 with --compositor cv2) and save. A video on the classic path goes
  through pipeline/video.py's batched stages (with --draw_box or an
  upsampler, through the per-image passes).
"""
from __future__ import annotations

import glob
import os

import torch

from codeformer_tpu_torch.utils import img_util
from codeformer_tpu_torch.utils.profiler import stage

def _fused_mode(args) -> str:
    """Normalize --fused_pipeline to 'auto' | 'on' | 'off' (older callers
    may still pass a boolean)."""
    v = getattr(args, 'fused_pipeline', 'off')
    if v is True:
        return 'on'
    if v in (False, None):
        return 'off'
    return v


def _fused_ineligibility(args, input_video, input_img_list):
    """Why the fused device pipeline cannot serve this invocation, or
    None if it can. Folder images must already be loaded (size and gray
    checks)."""
    if args.bg_upsampler == 'realesrgan' or args.face_upsample:
        return 'bg/face upsampler requested'
    if args.draw_box:
        return 'draw_box requested'
    if not args.detection_model.startswith('retinaface'):
        return f'detector {args.detection_model} keeps host preprocessing'
    if not input_video:
        shapes = {im.shape for im in input_img_list}
        if len(shapes) != 1:
            return f'folder images differ in size ({len(shapes)} shapes)'
        if any(img_util.is_gray(im, threshold=10)
               for im in input_img_list):
            return 'grayscale inputs need per-face tone adaptation'
    return None


def run_whole_images(args, input_img_list, result_root, restorer,
                     input_video, video_meta=None):
    """Restore whole images or a video's frames and write
    cropped_faces/, restored_faces/ and final_results/ (and the video)
    under result_root."""
    bg_upsampler, face_upsampler = _upsamplers(args, restorer.device)

    # fused or classic, decided before the helper is built (the fused
    # pipeline detects and parses in bf16 on the card; the classic path
    # in fp32, the reference's numerics). Folder images load up front for
    # the eligibility checks.
    mode = _fused_mode(args)
    names = None
    if not input_video:
        import cv2
        loaded, names = [], []
        for i, entry in enumerate(input_img_list):
            if isinstance(entry, str):
                names.append(os.path.splitext(os.path.basename(entry))[0])
                img = cv2.imread(entry, cv2.IMREAD_COLOR)
                if img is None:
                    raise FileNotFoundError(f'cannot read image: {entry}')
                loaded.append(img)
            else:
                names.append(str(i).zfill(6))
                loaded.append(entry)
        input_img_list = loaded
    use_fused = False
    if mode != 'off':
        reason = _fused_ineligibility(args, input_video, input_img_list)
        if reason is None:
            use_fused = True
        elif mode == 'on':
            raise RuntimeError(
                f'--fused_pipeline on, but the fused pipeline cannot '
                f'serve this invocation: {reason}')
        else:
            print(f'Fused pipeline unavailable ({reason}); '
                  f'using the classic per-stage path.')

    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    aux_dtype = torch.bfloat16 \
        if use_fused and restorer.device.type == 'cuda' else torch.float32
    face_helper = FaceRestoreHelper(
        args.upscale, face_size=512, crop_ratio=(1, 1),
        det_model=args.detection_model, save_ext='png', use_parse=True,
        device=restorer.device, allow_random_weights=args.random_init,
        compositor=getattr(args, 'compositor', 'xla'),
        det_dtype=aux_dtype, parse_dtype=aux_dtype)
    video_name = (os.path.splitext(os.path.basename(args.input_path))[0]
                  if input_video else None)
    if use_fused:
        _run_fused(args, input_img_list, names, result_root, restorer,
                   face_helper, input_video, video_name, video_meta)
    elif input_video and not args.draw_box and bg_upsampler is None \
            and face_upsampler is None:
        # the classic batched video path: frames flow through each stage
        # in batches (pipeline/video.py)
        from codeformer_tpu_torch.pipeline.video import restore_video_frames
        restored_frames = restore_video_frames(
            list(input_img_list), restorer, face_helper,
            w=args.fidelity_weight, upscale=args.upscale,
            only_center_face=args.only_center_face)
        for i, frame in enumerate(restored_frames):
            img_util.imwrite(frame, os.path.join(
                result_root, 'final_results', f'{i:06d}.png'))
        _write_video(args, result_root, video_name, video_meta)
    else:
        if input_video:   # the classic path takes the frames as a list
            input_img_list = list(input_img_list)
            names = [str(i).zfill(6) for i in range(len(input_img_list))]
        _run_classic(args, input_img_list, names, result_root, restorer,
                     face_helper, bg_upsampler, face_upsampler)
        if input_video:
            _write_video(args, result_root, video_name, video_meta)


def _upsamplers(args, device):
    """(bg_upsampler, face_upsampler): the x2 Real-ESRGAN upsampler for
    --bg_upsampler realesrgan and for --face_upsample, one shared
    upsampler when both are asked (tile --bg_tile), else None."""
    if args.bg_upsampler != 'realesrgan' and not args.face_upsample:
        return None, None
    from codeformer_tpu_torch.pipeline.realesrgan import set_realesrgan
    upsampler = set_realesrgan(tile=getattr(args, 'bg_tile', 400),
                               allow_random=args.random_init, device=device)
    return (upsampler if args.bg_upsampler == 'realesrgan' else None,
            upsampler if args.face_upsample else None)


def _save_faces(args, result_root, basename, cropped, restored):
    for idx, (cropped_face, restored_face) in enumerate(zip(cropped,
                                                            restored)):
        img_util.imwrite(cropped_face, os.path.join(
            result_root, 'cropped_faces', f'{basename}_{idx:02d}.png'))
        face_name = f'{basename}_{idx:02d}.png'
        if args.suffix is not None:
            face_name = f'{face_name[:-4]}_{args.suffix}.png'
        img_util.imwrite(restored_face, os.path.join(
            result_root, 'restored_faces', face_name))


def _save_final(args, result_root, basename, img):
    save_base = basename if args.suffix is None \
        else f'{basename}_{args.suffix}'
    img_util.imwrite(img, os.path.join(result_root, 'final_results',
                                       f'{save_base}.png'))


def _run_fused(args, input_img_list, names, result_root, restorer,
               face_helper, input_video, video_name, video_meta):
    """Everything on the device between stages."""
    from codeformer_tpu_torch.pipeline.device_pipeline import \
        DeviceRestorePipeline
    pipe = DeviceRestorePipeline(
        restorer, face_helper, upscale=args.upscale,
        w=args.fidelity_weight, only_center_face=args.only_center_face,
        parse_res=getattr(args, 'parse_res', 256))
    if not input_video:
        restored_frames, faces = pipe.restore_frames(input_img_list,
                                                     return_faces=True)
        for i, (name, frame) in enumerate(zip(names, restored_frames)):
            print(f'[{i + 1}/{len(names)}] Processing: {name} '
                  f'({len(faces[i])} faces)')
            _save_faces(args, result_root, name,
                        [c for c, _ in faces[i]], [r for _, r in faces[i]])
            _save_final(args, result_root, name, frame)
        return
    # streaming: frames are pulled from the (lazy) source chunk by chunk
    # and written straight to the encoder, bounded memory for any length;
    # a PNG a frame as the reference writes
    from codeformer_tpu_torch.utils.video_util import make_video_writer
    writer = None
    n = 0
    try:
        for frame in pipe.restore_frames_stream(iter(input_img_list)):
            img_util.imwrite(frame, os.path.join(
                result_root, 'final_results', f'{n:06d}.png'))
            if writer is None:
                meta = video_meta or {}
                fps = meta.get('fps', 24.0)
                if args.save_video_fps is not None:
                    fps = args.save_video_fps
                writer = make_video_writer(
                    os.path.join(result_root, f'{video_name}.mp4'),
                    frame.shape[0], frame.shape[1], fps, meta.get('audio'))
                print('Video Saving (streaming)...')
            writer.write_frame(frame)
            n += 1
    finally:
        if writer is not None:
            writer.close()


def _run_classic(args, input_img_list, names, result_root, restorer,
                 face_helper, bg_upsampler=None, face_upsampler=None):
    """The classic per-stage folder path, in four passes."""
    w = args.fidelity_weight
    # pass 1 (per image): read + detect + align, collect all faces
    records = []
    all_faces = []
    with stage('folder_detect_align'):
        for i, (img, basename) in enumerate(zip(input_img_list, names)):
            face_helper.clean_all()
            print(f'[{i + 1}/{len(input_img_list)}] Processing: {basename}')
            face_helper.read_image(img)
            num_det_faces = face_helper.get_face_landmarks_5(
                only_center_face=args.only_center_face, resize=640,
                eye_dist_threshold=5)
            print(f'\tdetect {num_det_faces} faces')
            face_helper.align_warp_face()
            face_helper.get_inverse_affine(None)
            records.append({
                'basename': basename,
                'input_img': face_helper.input_img,
                'is_gray': face_helper.is_gray,
                'cropped': list(face_helper.cropped_faces),
                'inv_affines': list(face_helper.inverse_affine_matrices),
                'start': len(all_faces),
            })
            all_faces.extend(face_helper.cropped_faces)

    # pass 2: ONE bucketed restoration stream over every face
    with stage('folder_restore'):
        restored_all = restorer.restore_batch(all_faces, w=w, adain=True) \
            if all_faces else []

    # pass 3: per-face gray adaptation, then one parsing stream
    processed = []
    for rec in records:
        face_helper.clean_all()
        face_helper.is_gray = rec['is_gray']
        for j, cropped in enumerate(rec['cropped']):
            face_helper.add_restored_face(restored_all[rec['start'] + j],
                                          cropped)
        rec['restored'] = list(face_helper.restored_faces)
        processed.extend(face_helper.restored_faces)
    # with a face upsampler the reference parses the upsampled faces:
    # then each image's paste parses its own
    parse_ids_all = None
    if face_helper.use_parse and processed and face_upsampler is None:
        with stage('folder_parse'):
            parse_ids_all = face_helper._parse_masks(processed)

    # pass 4 (per image): background upsample + paste + save
    for rec in records:
        face_helper.clean_all()
        face_helper.input_img = rec['input_img']
        face_helper.is_gray = rec['is_gray']
        face_helper.restored_faces = rec['restored']
        face_helper.inverse_affine_matrices = rec['inv_affines']
        n = len(rec['cropped'])
        bg_img = None
        if bg_upsampler is not None:
            with stage('folder_bg_upsample'):
                bg_img = bg_upsampler.enhance(rec['input_img'],
                                              outscale=args.upscale)[0]
        if parse_ids_all is not None:
            face_helper._precomputed_parse_ids = \
                parse_ids_all[rec['start']:rec['start'] + n]
        try:
            with stage('folder_paste'):
                restored_img = face_helper.paste_faces_to_input_image(
                    upsample_img=bg_img, draw_box=args.draw_box,
                    face_upsampler=face_upsampler)
        finally:
            face_helper._precomputed_parse_ids = None
        _save_faces(args, result_root, rec['basename'], rec['cropped'],
                    rec['restored'])
        _save_final(args, result_root, rec['basename'], restored_img)


def _write_video(args, result_root, video_name, video_meta):
    """Encode final_results/ into <result_root>/<video_name>.mp4."""
    import cv2

    from codeformer_tpu_torch.utils.video_util import make_video_writer
    print('Video Saving...')
    img_list = sorted(glob.glob(
        os.path.join(result_root, 'final_results', '*.[jp][pn]g')))
    video_frames = [cv2.imread(p) for p in img_list]
    height, width = video_frames[0].shape[:2]
    fps = (video_meta or {}).get('fps', 24.0)
    audio = (video_meta or {}).get('audio')
    if args.save_video_fps is not None:
        fps = args.save_video_fps
    vidwriter = make_video_writer(
        os.path.join(result_root, f'{video_name}.mp4'), height, width, fps,
        audio)
    for f in video_frames:
        vidwriter.write_frame(f)
    vidwriter.close()
